"""The port's semantic-speaker data preparation against the JAX package's
``data/semantic_prep.py``, and the two trans7time helpers of
``utils/fileio.py``.

Both packages' ``textgrid`` and ``json`` subcommands run on the same Praat
TextGrids, each in a directory of its own with the same relative paths, and
every file they write (the trans7time files, the scp, the dialogue and turn
JSONL) is byte-equal: a hand-written grid with an empty interval and an
escaped quote, seeded conversations of 2-4 speakers whose last window is the
right-anchored tail, and a single speaker without sentence endings, each at
the default window (96 / 32 characters) and a short one (12 / 5).
"""

import json
import os

import numpy as np
import pytest

from speaker3d_tpu.data import semantic_prep as jprep
from speaker3d_tpu.utils import fileio as jfileio
from speaker3d_tpu_torch.data import semantic_prep as tprep
from speaker3d_tpu_torch.utils import fileio as tfileio
from tests.torch_threads import cap_torch_threads  # noqa: F401

HAND = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 10
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "SPK_A"
        xmin = 0
        xmax = 10
        intervals: size = 3
        intervals [1]:
            xmin = 0
            xmax = 2.5
            text = "你好。今天天气不错。"
        intervals [2]:
            xmin = 5
            xmax = 7
            text = "他说""走吧""。"
        intervals [3]:
            xmin = 7
            xmax = 8
            text = "  "
    item [2]:
        class = "IntervalTier"
        name = "SPK_B"
        xmin = 0
        xmax = 10
        intervals: size = 2
        intervals [1]:
            xmin = 2.5
            xmax = 5
            text = "同意！走吧？"
        intervals [2]:
            xmin = 7
            xmax = 9
            text = ""
'''


def conversation_textgrid(seed: int, n_spk: int, n_turns: int,
                          endings: bool = True) -> str:
    """A seeded Praat TextGrid: one tier per speaker, turns alternating
    between random speakers, each speaker writing from a character set of
    its own, sentences ending in 。？！ (or no ending at all)."""
    rng = np.random.default_rng(seed)
    charsets = [[chr(0x4E00 + 40 * s + k) for k in range(30)]
                for s in range(n_spk)]
    tiers = [[] for _ in range(n_spk)]
    t = 0.0
    for _ in range(n_turns):
        spk = int(rng.integers(n_spk))
        text = ""
        for _ in range(int(rng.integers(1, 4))):
            text += "".join(rng.choice(charsets[spk], rng.integers(3, 15)))
            if rng.random() < 0.3:
                text += "，" + "".join(rng.choice(charsets[spk], 4))
            if endings:
                text += str(rng.choice(["。", "？", "！"]))
        dur = round(float(rng.uniform(0.5, 4.0)), 3)
        tiers[spk].append((round(t, 3), round(t + dur, 3), text))
        t += dur + round(float(rng.uniform(0.0, 0.5)), 3)
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {t:.3f}", "tiers? <exists>",
             f"size = {n_spk}", "item []:"]
    for s, intervals in enumerate(tiers):
        lines += [f"    item [{s + 1}]:", '        class = "IntervalTier"',
                  f'        name = "spk{s}"', "        xmin = 0",
                  f"        xmax = {t:.3f}",
                  f"        intervals: size = {len(intervals)}"]
        for i, (a, b, text) in enumerate(intervals):
            lines += [f"        intervals [{i + 1}]:",
                      f"            xmin = {a}", f"            xmax = {b}",
                      f'            text = "{text}"']
    return "\n".join(lines) + "\n"


GRIDS = {
    "hand": {"meetingA": HAND},
    "conversations": {f"conv{i}": conversation_textgrid(i, 2 + i % 3, 12 + i)
                      for i in range(4)},
    "one_speaker_no_endings": {"mono": conversation_textgrid(
        9, 1, 8, endings=False)},
}


def _run(prep, root, grids, length, shift):
    """Both subcommands of ``prep`` from ``root``, with relative paths."""
    os.makedirs(os.path.join(root, "tg"))
    for name, text in grids.items():
        with open(os.path.join(root, "tg", f"{name}.TextGrid"), "w",
                  encoding="utf-8") as f:
            f.write(text)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert prep.main(["textgrid", "--textgrid_dir", "tg", "--out_dir",
                          "t7t", "--scp", "t7t.scp"]) == 0
        assert prep.main(["json", "--trans7time_scp", "t7t.scp",
                          "--dialogue_out", "dialogue.jsonl", "--turn_out",
                          "turn.jsonl", "--sentence_length", str(length),
                          "--sentence_shift", str(shift)]) == 0
    finally:
        os.chdir(cwd)
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("length,shift", [(96, 32), (12, 5)])
@pytest.mark.parametrize("grids", sorted(GRIDS))
def test_outputs_byte_equal_to_the_jax_module(tmp_path, grids, length,
                                              shift):
    want = _run(jprep, str(tmp_path / "jax"), GRIDS[grids], length, shift)
    got = _run(tprep, str(tmp_path / "port"), GRIDS[grids], length, shift)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    rows = [json.loads(line) for line in
            got["turn.jsonl"].decode("utf-8").splitlines()]
    assert rows
    if grids == "conversations":
        # several windows per conversation, the tail window among them
        assert len(rows) > 2 * len(GRIDS[grids])
        assert any(r["change_point_list"] for r in rows)
    if grids == "hand":
        assert any('"' in r["text"] for r in rows)


def test_trans7time_helpers_round_trip(tmp_path):
    entries = [("A", 0.0, 1.25, "你好。今天天气不错。"),
               ("B", 1.25, 2.0, "two words\nand a line"),
               ("A", 2.0, 3.5, ""), ("C", 3.5, 4.0, 7)]
    paths = {}
    for name, module in (("jax", jfileio), ("port", tfileio)):
        paths[name] = str(tmp_path / f"{name}.trans7time")
        module.write_trans7time_list(paths[name], entries)
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    got = tfileio.load_trans7time_list(paths["port"])
    assert got == jfileio.load_trans7time_list(paths["port"])
    assert got[1] == ("B", 1.25, 2.0, "twowordsandaline")
    assert got[2] == ("A", 2.0, 3.5, "") and got[3][3] == "7"
    bad = tmp_path / "bad.trans7time"
    bad.write_text("A 0.0\n")
    with pytest.raises(ValueError, match="item 0"):
        tfileio.load_trans7time_list(str(bad))
