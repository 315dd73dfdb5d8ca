"""The PyTorch port's DER scoring (diar/der.py, cli/compute_der.py) against
the JAX package's: ``compute_der`` equal to 1e-12 on a hypothesis sweep of
random reference and hypothesis segment lists, with collar and overlap, and
the two ``compute_der`` CLIs printing identical text."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.cli import compute_der as jcli
from speaker3d_tpu.diar import der as jder
from speaker3d_tpu_torch.cli import compute_der as tcli
from speaker3d_tpu_torch.diar import der as tder


def _segments(draw, n, speakers):
    segs = []
    for _ in range(n):
        st_ = draw(st.floats(0.0, 30.0, allow_nan=False))
        dur = draw(st.floats(0.01, 8.0, allow_nan=False))
        segs.append((st_, st_ + dur, draw(st.sampled_from(speakers))))
    return segs


@st.composite
def ref_hyp(draw):
    ref = _segments(draw, draw(st.integers(0, 8)), ["A", "B", "C"])
    hyp = _segments(draw, draw(st.integers(0, 8)), ["x", "y", "z", "w"])
    return ref, hyp


def _same(got, want):
    for field in ("miss", "fa", "spkerr", "total"):
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-12, field
    assert abs(got.der - want.der) <= 1e-12
    assert repr(got) == repr(want)


@settings(max_examples=120, deadline=None)
@given(case=ref_hyp(), collar=st.sampled_from([0.0, 0.1, 0.25, 0.5]),
       ignore_overlap=st.booleans())
def test_compute_der_equals_jax(case, collar, ignore_overlap):
    ref, hyp = case
    _same(tder.compute_der(ref, hyp, collar, ignore_overlap),
          jder.compute_der(ref, hyp, collar, ignore_overlap))
    span = (-np.inf, np.inf)
    _same(tder.compute_der(ref, hyp, collar, ignore_overlap, uem=span),
          jder.compute_der(ref, hyp, collar, ignore_overlap, uem=span))


@settings(max_examples=30, deadline=None)
@given(files=st.lists(ref_hyp(), min_size=1, max_size=3),
       collar=st.sampled_from([0.0, 0.25]))
def test_corpus_der_equals_jax(files, collar):
    ref = {f"f{i}": r for i, (r, _) in enumerate(files)}
    hyp = {f"f{i}": h for i, (_, h) in enumerate(files)}
    _same(tder.compute_der_for_files(ref, hyp, collar),
          jder.compute_der_for_files(ref, hyp, collar))


def _write_rttm(path, segs_by_file):
    with open(path, "w") as f:
        for fid, segs in segs_by_file.items():
            for st_, ed, spk in segs:
                f.write(f"SPEAKER {fid} 1 {st_:.3f} {ed - st_:.3f} <NA> <NA> "
                        f"{spk} <NA> <NA>\n")


@pytest.mark.parametrize("extra", [[], ["--collar", "0.0"],
                                   ["--ignore_overlap"]])
def test_cli_prints_identical_text(tmp_path, capsys, extra):
    rng = np.random.default_rng(0)
    ref, hyp = {}, {}
    for fid in ("conv1", "conv2"):
        starts = np.sort(rng.uniform(0, 60, 12))
        ref[fid] = [(s, s + rng.uniform(0.5, 5), "AB"[i % 2])
                    for i, s in enumerate(starts)]
        hyp[fid] = [(s + rng.normal(0, 0.2), s + rng.uniform(0.5, 5), "xyz"[
            rng.integers(3)]) for s in starts]
    _write_rttm(tmp_path / "ref.rttm", ref)
    _write_rttm(tmp_path / "hyp.rttm", {"conv1": hyp["conv1"]})
    argv = ["--ref", str(tmp_path / "ref.rttm"), "--hyp",
            str(tmp_path / "hyp.rttm")] + extra
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.count("\n") == 4 and got.startswith("conv1: DER ")
    assert tder.load_rttm(tmp_path / "ref.rttm") == jder.load_rttm(
        tmp_path / "ref.rttm")
