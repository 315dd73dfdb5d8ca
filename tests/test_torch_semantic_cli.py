"""The port's semantic-speaker CLI against the JAX package's
``cli/semantic.py``.

- ``encode`` and ``CharTokenizer`` give the JAX CLI's arrays (ties in
  ``Counter.most_common`` decide the ids).
- Both CLIs run ``dialogue`` and ``turn`` from one set of weights through
  ``--pretrained`` directories written here: the JAX model's Flax
  ``save_pretrained`` for the JAX CLI, its parameters through the port's
  converter as ``model.safetensors`` for the port, one generated
  ``vocab.txt`` for both (``AutoTokenizer``: ``[CLS]``, one id per
  character, ``[SEP]``). The JAX CLI runs on a one-device mesh
  (``make_mesh`` patched): its own ``make_mesh(model=1)`` spans the tests'
  8 virtual devices, where the token loss is a mean of per-shard means. The
  epoch losses agree at 1e-4 (the printed precision) and ``metrics.json``
  is equal.
- A run over several cards is refused, naming M14.
- The char path (no ``--pretrained``) learns on the CPU, on
  ``tests/test_semantic_cli.py``'s two texts: the last epoch's loss under
  half the first's (32 steps) and every eval row right.
"""

import json
import os
import re

import jax
import numpy as np
import pytest

from speaker3d_tpu.cli import semantic as jcli
from speaker3d_tpu.parallel import mesh as jmesh
from speaker3d_tpu.semantic import bert as jbert
from speaker3d_tpu_torch.cli import semantic as tcli
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from tests.torch_threads import cap_torch_threads  # noqa: F401

TOL = 1e-4
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PUNCT = ["。", "？", "！", "，"]
N_CHARS = 64                      # CJK characters from U+4E00
TINY = dict(num_labels=2, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2)
ARGS = ["--max_seq_length", "16", "--batch_size", "8", "--epochs", "2",
        "--lr", "0.005"]


def _rows(seed, n):
    """Dialogue and turn rows: 10-20 characters, from one speaker's half of
    the characters, or two speakers' halves with a change point."""
    rng = np.random.default_rng(seed)
    half = N_CHARS // 2
    dialogue, turn = [], []
    for _ in range(n):
        length = int(rng.integers(10, 21))
        a = int(rng.integers(2))
        chars = [chr(0x4E00 + a * half + int(k))
                 for k in rng.integers(0, half, length)]
        labels = [0] * length
        if rng.random() < 0.5:
            cut = int(rng.integers(3, length - 2))
            chars[cut:] = [chr(0x4E00 + (1 - a) * half + int(k))
                           for k in rng.integers(0, half, length - cut)]
            labels[cut] = 1
        chars[-1] = str(rng.choice(PUNCT))
        text = "".join(chars)
        dialogue.append({"text": text, "label": int(sum(labels) > 0)})
        turn.append({"text": text, "labels": labels})
    return dialogue, turn


def _write_jsonl(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("semantic")
    vocab = SPECIALS + PUNCT + [chr(0x4E00 + i) for i in range(N_CHARS)]
    files = {}
    for split, seed, n in (("train", 0, 36), ("eval", 1, 12)):
        for task, rows in zip(("dialogue", "turn"), _rows(seed, n)):
            files[task, split] = str(root / f"{task}_{split}.jsonl")
            _write_jsonl(files[task, split], rows)
    dirs = {}
    for task, head in (("dialogue", "sequence"), ("turn", "token")):
        model = jbert.build_model(head, vocab_size=len(vocab), seed=3,
                                  **TINY)
        jdir, tdir = root / f"{task}_flax", root / f"{task}_torch"
        model.save_pretrained(str(jdir))
        os.makedirs(tdir)
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in state_dict_from_flax(
            {"params": model.params}).items()},
            str(tdir / "model.safetensors"))
        with open(jdir / "config.json") as f:
            config = f.read()
        for d in (jdir, tdir):
            (d / "vocab.txt").write_text("\n".join(vocab) + "\n",
                                         encoding="utf-8")
            (d / "config.json").write_text(config)
        dirs[task] = (str(jdir), str(tdir))
    return {"files": files, "dirs": dirs, "root": root, "vocab": vocab}


def test_encode_and_char_tokenizer_match(corpus):
    rows = tcli.load_jsonl(corpus["files"]["turn", "train"])
    assert rows == jcli.load_jsonl(corpus["files"]["turn", "train"])
    texts = [r["text"] for r in rows] + ["aabbc", "cbba"]
    jtok, ttok = jcli.CharTokenizer(texts), tcli.CharTokenizer(texts)
    assert ttok.vocab == jtok.vocab and ttok.vocab_size == jtok.vocab_size
    assert tcli.CharTokenizer(["a"]).vocab_size == 5  # at least 5
    for token_level in (False, True):
        task = "turn" if token_level else "dialogue"
        rows = tcli.load_jsonl(corpus["files"][task, "train"])
        for length in (8, 16, 32):
            got = tcli.encode(rows, ttok, length, token_level)
            want = jcli.encode(rows, jtok, length, token_level)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_pretrained_tokenizer_gives_one_id_per_character(corpus):
    tokenizer, vocab_size = tcli.pretrained_tokenizer(corpus["dirs"]["turn"][1])
    vocab = corpus["vocab"]
    assert vocab_size == len(vocab)
    text = "".join(vocab[5:12])
    ids, mask = tokenizer(text, 12)
    assert ids == [2] + list(range(5, 12)) + [3, 0, 0, 0]
    assert mask == [1] * 9 + [0] * 3
    ids, mask = tokenizer(text, 6)  # truncated: [CLS], 4 characters, [SEP]
    assert ids == [2, 5, 6, 7, 8, 3] and mask == [1] * 6


def _epoch_losses(out):
    return [float(x) for x in re.findall(r"^epoch \d+: loss ([\d.]+)$", out,
                                         re.M)]


@pytest.mark.parametrize("task", ["dialogue", "turn"])
def test_both_clis_agree_through_pretrained(corpus, task, monkeypatch,
                                            capsys):
    one_device = jmesh.make_mesh(1, 1, devices=jax.devices()[:1])
    monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: one_device)
    files, (jdir, tdir) = corpus["files"], corpus["dirs"][task]
    exp = {}
    for name, cli, extra in (("jax", jcli, ["--pretrained", jdir]),
                             ("port", tcli, ["--pretrained", tdir,
                                             "--device", "cpu"])):
        exp[name] = str(corpus["root"] / f"exp_{task}_{name}")
        capsys.readouterr()
        cli.main([task, "--train", files[task, "train"], "--eval",
                  files[task, "eval"], "--exp_dir", exp[name]] + ARGS + extra)
        exp[name] = (exp[name], capsys.readouterr().out)
    losses = {k: _epoch_losses(out) for k, (_, out) in exp.items()}
    assert len(losses["jax"]) == 2, exp["jax"][1]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=0,
                               atol=TOL + 1e-9)
    metrics = {}
    for name, (d, _) in exp.items():
        with open(os.path.join(d, "metrics.json")) as f:
            metrics[name] = json.load(f)
    assert metrics["port"] == metrics["jax"]
    assert "steps of 8, step" in exp["port"][1]


def test_char_path_learns(tmp_path, capsys):
    rows_tr = [{"text": "aaaa bbbb", "label": 0},
               {"text": "cccc cccc", "label": 1}] * 32
    tr, ev = str(tmp_path / "train.jsonl"), str(tmp_path / "eval.jsonl")
    _write_jsonl(tr, rows_tr)
    _write_jsonl(ev, rows_tr[:8])
    exp = str(tmp_path / "exp")
    tcli.main(["dialogue", "--train", tr, "--eval", ev, "--exp_dir", exp,
               "--epochs", "4", "--batch_size", "8", "--max_seq_length",
               "16", "--hidden_size", "32", "--num_layers", "2", "--lr",
               "0.005", "--device", "cpu"])
    losses = _epoch_losses(capsys.readouterr().out)
    with open(os.path.join(exp, "metrics.json")) as f:
        m = json.load(f)
    assert len(losses) == 4 and losses[-1] < 0.5 * losses[0], losses
    assert m["accuracy"] == 1.0, m


def test_several_cards_are_refused(corpus, monkeypatch):
    files = corpus["files"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(NotImplementedError, match="M14"):
        tcli.main(["turn", "--train", files["turn", "train"], "--eval",
                   files["turn", "eval"], "--exp_dir",
                   str(corpus["root"] / "exp_m14"), "--device", "cpu"])
