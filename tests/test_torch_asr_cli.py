"""The port's CTC trainer CLI and transcriber against the JAX package's.

One seeded corpus of tone words (``tests/test_asr_ctc.py``'s utterances,
3 s and 5 s, one word spelled in CJK) trains an experiment with each
package's ``train_asr_ctc`` CLI on the CPU. The port's loader gives the
JAX CLI's batches byte for byte; ``vocab.json`` is byte-equal and
``cmvn.npy`` agrees within the two fbanks' rounding; the port's CLI resumes
from its own checkpoint and from the JAX CLI's. Both packages'
``CTCTranscriber`` read both experiments and give identical tokens and
timestamps on a 9 s recording (three 4 s windows), and both
``transcribe_diarization`` CLIs write identical bytes with
``--asr_exp_dir`` on the port's experiment. The module runs at the xdist
worker's share of the cores (``tests/torch_threads.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import yaml

from tests.test_asr_ctc import _utterance
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
SPELLING = {"bip": "bip", "bop": "bop", "beep": "哔"}
N_UTTS, BATCH = 48, 8
PORT_EPOCHS, JAX_EPOCHS = 40, 2
SPE = N_UTTS // BATCH


def write_corpus(root):
    """N_UTTS seeded word utterances under ``root`` and their
    ``train.csv``."""
    from speaker3d_tpu_torch.utils.fileio import write_wav

    os.makedirs(os.path.join(root, "wav"))
    rng = np.random.default_rng(7)
    words = list(SPELLING)
    with open(os.path.join(root, "train.csv"), "w", encoding="utf-8") as f:
        f.write("ID,wav,text\n")
        for i in range(N_UTTS):
            said = [words[j] for j in rng.integers(0, 3, rng.integers(2, 5))]
            # every third is longer than wav_len (a random crop)
            wav, _ = _utterance(said, rng, total_s=3.0 + 2.0 * (i % 3 == 0))
            path = os.path.join(root, "wav", f"u{i}.wav")
            write_wav(path, wav, FS)
            f.write(f"u{i},{path},{' '.join(SPELLING[w] for w in said)}\n")
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("asr_cli")))


def asr_config(root, name, epochs):
    cfg = {"exp_dir": os.path.join(root, name),
           "data": os.path.join(root, "train.csv"), "sample_rate": FS,
           "wav_len": 4.0, "batch_size": BATCH, "num_epoch": epochs,
           "max_lr": 5e-3, "warmup_epoch": 1,
           "model": {"args": {"feat_dim": 80, "d_model": 32, "num_heads": 2,
                              "ffn_dim": 64, "num_layers": 2,
                              "kernel_size": 7}}}
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg["exp_dir"]


@pytest.fixture(scope="module")
def port_exp(corpus):
    from speaker3d_tpu_torch.cli import train_asr_ctc

    path, exp = asr_config(corpus, "port_exp", PORT_EPOCHS)
    train_asr_ctc.main(["--config", path, "--device", "cpu"])
    return exp


@pytest.fixture(scope="module")
def jax_exp(corpus):
    """The JAX CLI's experiment, and the batches its train step took."""
    from speaker3d_tpu.cli import train_asr_ctc as jcli

    path, exp = asr_config(corpus, "jax_exp", JAX_EPOCHS)
    seen = []
    real = jcli.make_ctc_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return step(state, batch)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "make_ctc_train_step", recording)
        jcli.main(["--config", path])
    return exp, seen


def test_loader_batches_equal_the_jax_cli(corpus, jax_exp):
    from speaker3d_tpu_torch.cli.train_asr_ctc import build_vocab, ctc_batches
    from speaker3d_tpu_torch.utils.fileio import load_data_csv

    _, seen = jax_exp
    rows = load_data_csv(os.path.join(corpus, "train.csv"))
    tok2id = {t: i + 1 for i, t in enumerate(build_vocab(rows))}
    got = [b for epoch in range(1, JAX_EPOCHS + 1) for b in ctc_batches(
        rows, tok2id, batch_size=BATCH, wav_len=4 * FS, sample_rate=FS,
        seed=1234, epoch=epoch)]
    assert len(got) == len(seen) == JAX_EPOCHS * SPE
    for g, w in zip(got, seen):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k
    assert (got[0]["label_lens"] > 1).all()


def test_vocab_and_cmvn_equal_the_jax_cli(port_exp, jax_exp):
    exp, _ = jax_exp
    with open(os.path.join(port_exp, "vocab.json"), "rb") as f:
        got = f.read()
    with open(os.path.join(exp, "vocab.json"), "rb") as f:
        assert got == f.read()
    assert json.loads(got.decode("utf-8")) == ["bip", "bop", "哔"]
    got = np.load(os.path.join(port_exp, "cmvn.npy"))
    want = np.load(os.path.join(exp, "cmvn.npy"))
    assert got.shape == want.shape == (2, 80) and got.dtype == np.float32
    # the two fbanks' rounding (log-mel within ~1e-4 in weak bins)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _resume(corpus, src, name, epochs, capsys):
    from speaker3d_tpu_torch.cli import train_asr_ctc
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    path, exp = asr_config(corpus, name, epochs)
    shutil.copytree(src, exp)
    capsys.readouterr()
    train_asr_ctc.main(["--config", path, "--device", "cpu"])
    out = capsys.readouterr().out
    state = Checkpointer(os.path.join(exp, "models")).recover_if_possible()
    with open(os.path.join(exp, "train_epoch.log")) as f:
        log = f.read().splitlines()
    return out, int(state["train_state"]["step"]), log


def test_resumes_from_its_own_checkpoint(corpus, port_exp, capsys):
    out, step, log = _resume(corpus, port_exp, "port_resumed",
                             PORT_EPOCHS + 1, capsys)
    assert f"recovered from epoch {PORT_EPOCHS}" in out
    assert step == (PORT_EPOCHS + 1) * SPE
    assert len(log) == PORT_EPOCHS + 1
    assert log[-1].startswith(f"epoch: {PORT_EPOCHS + 1} - time_s: ")


def test_resumes_from_a_jax_checkpoint(corpus, jax_exp, capsys):
    exp, _ = jax_exp
    out, step, log = _resume(corpus, exp, "jax_resumed", JAX_EPOCHS + 1,
                             capsys)
    assert f"recovered from epoch {JAX_EPOCHS}" in out
    assert step == (JAX_EPOCHS + 1) * SPE
    assert len(log) == JAX_EPOCHS + 1


def _recording():
    rng = np.random.default_rng(99)
    return np.concatenate([_utterance(w, rng, total_s=3.0)[0] for w in (
        ["bip", "bop"], ["beep", "bip", "bop"], ["bop", "beep"])])


@pytest.mark.parametrize("which", ["port_exp", "jax_exp"])
def test_transcribers_agree_on_either_experiment(which, port_exp, jax_exp):
    from speaker3d_tpu.asr.ctc import CTCTranscriber as JaxTranscriber
    from speaker3d_tpu_torch.asr.ctc import CTCTranscriber

    exp = port_exp if which == "port_exp" else jax_exp[0]
    wav = _recording()
    port = CTCTranscriber(exp, device="cpu")
    windows = []
    decode = port._decode_window
    port._decode_window = lambda w: windows.append(len(w)) or decode(w)
    got = port.transcribe(wav)
    want = JaxTranscriber(exp).transcribe(wav)
    assert windows == [4 * FS] * 3
    assert got == want
    if which == "port_exp":  # trained long enough to emit tokens
        assert got["timestamp"], got


def test_cli_with_asr_exp_dir_equals_jax(port_exp, tmp_path, capsys):
    """Two speakers, each saying words, with a hand-written RTTM (as
    tests/test_asr_ctc.py's end-to-end test), and a recording without a
    wav."""
    from speaker3d_tpu.cli import transcribe_diarization as jcli
    from speaker3d_tpu_torch.cli import transcribe_diarization as tcli
    from speaker3d_tpu_torch.utils.fileio import write_wav

    rng = np.random.default_rng(5)
    wav_a, _ = _utterance(["bip", "bop"], rng, total_s=1.6)
    wav_b, _ = _utterance(["beep", "bip"], rng, total_s=1.6)
    wav = np.concatenate([wav_a, np.zeros(int(0.5 * FS), np.float32), wav_b,
                          _utterance(["bop", "beep", "bip"], rng)[0]])
    wav_dir, rttm_dir = tmp_path / "wavs", tmp_path / "rttm"
    wav_dir.mkdir()
    rttm_dir.mkdir()
    write_wav(str(wav_dir / "conv.wav"), wav, FS)
    (rttm_dir / "conv.rttm").write_text(
        "SPEAKER conv 0 0.000 1.600 <NA> <NA> spkA <NA> <NA>\n"
        "SPEAKER conv 0 2.100 1.600 <NA> <NA> spkB <NA> <NA>\n"
        "SPEAKER conv 0 3.700 3.000 <NA> <NA> spkA <NA> <NA>\n")
    (rttm_dir / "nowav.rttm").write_text(
        "SPEAKER nowav 0 0.000 1.000 <NA> <NA> spkA <NA> <NA>\n")
    outs = {}
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        out_dir = str(tmp_path / tag)
        argv = ["--rttm_dir", str(rttm_dir), "--asr_exp_dir", port_exp,
                "--wav_dir", str(wav_dir), "--out_dir", out_dir]
        if tag == "port":
            argv += ["--device", "cpu"]
        capsys.readouterr()
        assert main(argv) == 0
        printed = capsys.readouterr().out.replace(out_dir, "OUT")
        outs[tag] = (printed, {n: open(os.path.join(out_dir, n), "rb").read()
                               for n in sorted(os.listdir(out_dir))})
    assert outs["port"] == outs["jax"]
    assert "[WARNING] no wav for nowav, skipped" in outs["port"][0]
    lines = outs["port"][1]["conv.txt"].decode().splitlines()
    assert lines and all(ln.split(":")[0] in ("spkA", "spkB") for ln in lines)
