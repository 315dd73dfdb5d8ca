"""The port's speaker-attributed transcription against the JAX package's.

The host functions of ``diar/transcribe.py`` give the JAX ones' results on
``tests/test_transcribe.py``'s cases. Both ``transcribe_diarization`` CLIs
write identical bytes and print the same lines with ``--asr_dir`` (each
``--timestamps`` unit) and refuse the same bad flag sets with the same
message; ``tests/test_torch_asr_cli.py`` compares them with
``--asr_exp_dir`` on a port-trained CTC experiment.
"""

import copy
import json
import os

import pytest

from speaker3d_tpu.cli import transcribe_diarization as jcli
from speaker3d_tpu.diar import transcribe as jt
from speaker3d_tpu_torch.cli import transcribe_diarization as tcli
from speaker3d_tpu_torch.diar import transcribe as tt
from tests.test_transcribe import ASR, FIELDS
from tests.torch_threads import cap_torch_threads  # noqa: F401

ASR_MS = dict(ASR, timestamp=[[a * 1000, b * 1000] for a, b in
                              ASR["timestamp"]])
CASES = {
    "sentences": ("words_to_sentences",
                  (ASR["text"], ASR["raw_text"], ASR["timestamp"]), {}),
    "attribution": ("attribute_transcript", (ASR, FIELDS), {}),
    "ms_auto": ("attribute_transcript", (ASR_MS, FIELDS), {}),
    "ms_forced": ("attribute_transcript", (ASR_MS, FIELDS),
                  {"timestamps_ms": True}),
    "s_forced": ("attribute_transcript", (ASR, FIELDS),
                 {"timestamps_ms": False}),
    "no_overlap_keeps_previous": (
        "attribute_transcript",
        ({"text": "你好。后记", "raw_text": "你好 后记",
          "timestamp": [[0.0, 0.5], [9.0, 9.5]]}, [[0.0, 1.0, 3]]), {}),
    "malformed": ("attribute_transcript",
                  (dict(ASR, raw_text="完全 不同 的 词"), FIELDS), {}),
    "leading_words": ("attribute_transcript",
                      ({"text": "早。后记", "raw_text": "早 后记",
                        "timestamp": [[0.0, 0.3], [5.0, 5.4]]},
                       [[4.5, 6.0, "spkA"]]), {}),
    "merge_gap": ("attribute_transcript", (ASR, FIELDS, 0.5), {}),
    "match_spk": ("match_spk", ([["a", [0.5, 1.6]], ["b", [1.6, 2.0]]],
                                FIELDS), {}),
    "empty": ("distribute_speakers", ([], FIELDS), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_functions_equal_jax(case):
    name, args, kw = CASES[case]
    got = getattr(tt, name)(*copy.deepcopy(args), **kw)
    want = getattr(jt, name)(*copy.deepcopy(args), **kw)
    assert got == want
    assert tt.PUNC_PATTERN == jt.PUNC_PATTERN


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _outputs(out_dir):
    return {n: open(os.path.join(out_dir, n), "rb").read()
            for n in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("unit", ["auto", "ms", "s"])
def test_cli_with_asr_dir_equals_jax(tmp_path, capsys, unit):
    rttm_dir, asr_dir = tmp_path / "rttm", tmp_path / "asr"
    rttm_dir.mkdir()
    asr_dir.mkdir()
    (rttm_dir / "rec1.rttm").write_text(
        "SPEAKER rec1 0 0.000 1.000 <NA> <NA> 0 <NA> <NA>\n"
        "SPEAKER rec1 0 1.400 1.600 <NA> <NA> 1 <NA> <NA>\n")
    (rttm_dir / "rec2.rttm").write_text(  # no ASR json: a warning
        "SPEAKER rec2 0 0.000 1.000 <NA> <NA> 0 <NA> <NA>\n")
    (rttm_dir / "rec3.rttm").write_text(
        "SPEAKER rec3 0 0.500 3.000 <NA> <NA> spkA <NA> <NA>\n")
    (asr_dir / "rec1.json").write_text(json.dumps(
        ASR_MS if unit == "ms" else ASR))
    (asr_dir / "rec3.json").write_text(json.dumps(ASR))
    outs = {}
    for tag, main in (("port", tcli.main), ("jax", jcli.main)):
        out_dir = str(tmp_path / tag)
        argv = ["--rttm_dir", str(rttm_dir), "--asr_dir", str(asr_dir),
                "--out_dir", out_dir, "--timestamps", unit]
        if tag == "port":
            argv += ["--device", "cpu"]
        printed = _run(main, argv, capsys).replace(out_dir, "OUT")
        outs[tag] = (printed, _outputs(out_dir))
    assert outs["port"] == outs["jax"]
    assert "[WARNING] no ASR json for rec2, skipped" in outs["port"][0]
    assert sorted(outs["port"][1]) == ["rec1.txt", "rec3.txt"]


@pytest.mark.parametrize("argv", [
    ["--asr_dir", "a", "--asr_exp_dir", "b"], [],
    ["--asr_exp_dir", "b"]])
def test_cli_refusals_equal_jax(argv, capsys):
    base = ["--rttm_dir", "r", "--out_dir", "o"]
    errs = []
    for parse in (tcli.get_args, jcli.get_args):
        with pytest.raises(SystemExit) as e:
            parse(base + argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1] and "error:" in errs[0]


def test_cli_raises_without_a_card():
    """--device defaults to cuda and is resolved with --asr_dir too."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--rttm_dir", "r", "--asr_dir", "a", "--out_dir", "o"])
