"""The port's three batch diarization drivers
(``speaker3d_tpu_torch/cli/run_diarization_{simple,on_dir,speech_estimate}
.py`` with ``--device cpu``) against the root JAX drivers of the same name,
on ``tests/test_cli_extra.py``'s fixtures (eight one-second tone wavs, the
tiny x-vector experiment trained by the JAX trainer, read by both):

- the same files in the output directory, each JSON, RTTM and
  ``.vad_info.json`` byte-equal, the summary JSON byte-equal, and the same
  stdout (output paths written as ``<out>``);
- ``.meta.json`` and ``.pairs.json`` byte-equal but for the measured
  ``processing_time_sec`` and ``rtf`` and the cosines of the re-embedded
  segments (JAX's and the port's embeddings of one segment differ in their
  last bits), which are held within 1e-5;
- the same stdout, return codes and exceptions on an empty directory, a
  directory that does not exist and a missing ``--src_dir``.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import pytest

from tests.test_cli_extra import tiny_exp  # noqa: F401  (the fixture)
from tests.torch_threads import cap_torch_threads  # noqa: F401
from speaker3d_tpu_torch.cli import (
    run_diarization_on_dir as port_on_dir,
    run_diarization_simple as port_simple,
    run_diarization_speech_estimate as port_speech_estimate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COSINE_TOL = 1e-5
TIMED = ("processing_time_sec", "rtf")


def _root_driver(name):
    sys.path.insert(0, ROOT)
    try:
        return __import__(f"run_diarization_{name}")
    finally:
        sys.path.remove(ROOT)


def _call(main, argv, monkeypatch, port: bool):
    """(return code or exception, stdout, stderr) of one driver call; the
    root drivers read ``sys.argv``."""
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "argv", ["driver"] + argv)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv + ["--device", "cpu"]) if port else main()
        except SystemExit as e:
            rc = ("SystemExit", e.code)
        except Exception as e:  # noqa: BLE001 - compared across packages
            rc = (type(e).__name__, str(e))
    return rc, out.getvalue(), err.getvalue()


def _close(a, b, path=""):
    """JSON values equal but for floats under a cosine key (within
    COSINE_TOL)."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            if "cosine" in k and isinstance(a[k], float):
                assert abs(a[k] - b[k]) <= COSINE_TOL, (path, k, a[k], b[k])
            else:
                _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _same_outputs(want_dir, got_dir):
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir))
    kinds = set()
    for name in names:
        if name.endswith(".png"):  # the VAD plot: best-effort, not compared
            continue
        with open(os.path.join(want_dir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(got_dir, name), "rb") as f:
            got = f.read()
        kind = "." + name.split(".", 1)[1]
        kinds.add(kind)
        if kind in (".meta.json", ".pairs.json"):
            w, g = json.loads(want), json.loads(got)
            for k in TIMED:
                w.pop(k, None)
                g.pop(k, None)
            _close(w, g, name)
        else:
            assert got == want, name
    return kinds


def _norm(text, *dirs):
    for d in dirs:
        text = text.replace(d, "<out>")
    return text


def test_simple_driver_rttm(tiny_exp, tmp_path, monkeypatch):  # noqa: F811
    """RTTM here; the other two drivers write JSON."""
    root, config, _ = tiny_exp
    src = os.path.join(root, "wav")
    runs = {}
    for who, main in (("jax", _root_driver("simple").main),
                      ("port", port_simple.main)):
        out = str(tmp_path / who)
        runs[who] = (out, _call(
            main, ["--src_dir", src, "--out_dir", out, "--exp_dir",
                   config["exp_dir"], "--out_type", "rttm"], monkeypatch,
            who == "port"))
    (wdir, (wrc, wout, _)), (gdir, (grc, gout, _)) = runs["jax"], runs["port"]
    assert grc == wrc is None
    assert _norm(gout, gdir) == _norm(wout, wdir)
    kinds = _same_outputs(wdir, gdir)
    assert {".rttm", ".vad_info.json", ".meta.json", ".pairs.json"} <= kinds


def test_on_dir_driver_with_summary(tiny_exp, tmp_path,  # noqa: F811
                                    monkeypatch):
    root, config, rows = tiny_exp
    src = os.path.join(root, "wav")
    res = {}
    for who, main in (("jax", _root_driver("on_dir").main),
                      ("port", port_on_dir.main)):
        out, summary = str(tmp_path / who), str(tmp_path / f"{who}.json")
        res[who] = (out, summary, _call(
            main, ["--src_dir", src, "--pattern", "*.wav", "--out_dir", out,
                   "--summary_out", summary, "--exp_dir", config["exp_dir"],
                   "--per_sentence_reindex"], monkeypatch, who == "port"))
    (wdir, wsum, (wrc, wout, _)), (gdir, gsum, (grc, gout, _)) = (
        res["jax"], res["port"])
    assert grc == wrc == 0
    assert _norm(gout, gdir, gsum) == _norm(wout, wdir, wsum)
    with open(wsum, "rb") as f, open(gsum, "rb") as g:
        want = f.read()
        assert g.read() == want
    assert len(json.loads(want)) == len(rows)
    assert {".json", ".meta.json", ".pairs.json"} <= _same_outputs(wdir,
                                                                    gdir)


def test_speech_estimate_driver(tiny_exp, tmp_path, monkeypatch):  # noqa: F811
    root, config, rows = tiny_exp
    src = str(tmp_path / "estimates")
    os.makedirs(src)
    for rid, p, _ in rows[:2]:
        shutil.copy(p, os.path.join(src, f"{rid}_speech_estimate.wav"))
    default_out = str(tmp_path / "estimates_3dspeaker_diarization")
    argv = ["--src_dir", src, "--exp_dir", config["exp_dir"],
            "--speaker_num", "1", "--vad_min_speech_ms", "150",
            "--vad_max_silence_ms", "250", "--cluster_mer_cos", "0.3",
            "--batch_size", "8"]
    want = _call(_root_driver("speech_estimate").main, argv, monkeypatch,
                 False)
    shutil.move(default_out, str(tmp_path / "jax_out"))
    got = _call(port_speech_estimate.main, argv, monkeypatch, True)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]  # the same default out_dir both times
    kinds = _same_outputs(str(tmp_path / "jax_out"), default_out)
    assert {".json", ".meta.json", ".pairs.json"} <= kinds


@pytest.mark.parametrize("case", ["empty", "absent", "no_src_dir"])
def test_drivers_refuse_alike(case, tiny_exp, tmp_path,  # noqa: F811
                              monkeypatch):
    _, config, _ = tiny_exp
    src = str(tmp_path / "src")
    if case == "empty":
        os.makedirs(src)
    for name, port, extra in (
            ("simple", port_simple.main, ["--out_dir", str(tmp_path / "o")]),
            ("on_dir", port_on_dir.main, []),
            ("speech_estimate", port_speech_estimate.main, [])):
        argv = ([] if case == "no_src_dir" else ["--src_dir", src]) + extra
        argv += ["--exp_dir", config["exp_dir"]]
        (wrc, wout, werr) = _call(_root_driver(name).main, argv,
                                  monkeypatch, False)
        (grc, gout, gerr) = _call(port, argv, monkeypatch, True)
        # argparse's usage line lists the port's --device too
        assert (grc, gout, gerr.splitlines()[-1:]) == (
            wrc, wout, werr.splitlines()[-1:]), name
