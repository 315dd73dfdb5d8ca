"""Sequential-speaker boundaries in the port (diar/gmm.py,
diar/boundaries.py, cli/detect_boundaries.py) against scikit-learn and the
JAX package.

- The port's diagonal GMM against ``sklearn.mixture.GaussianMixture(k,
  covariance_type="diag", max_iter=100, random_state=0)`` at the
  boundaries' shapes (50 samples, d = 16 and 192, 1 and 2 components) on
  separated and overlapping seeded sets: ``score_samples`` within 1e-6
  relative, weights, means and variances within 1e-6 up to the order of
  the components, ``converged_`` equal.
- ``find_precise_boundary``, ``find_precise_boundary_gmm`` and
  ``detect_speaker_boundaries`` (cosine and gmm) equal to the JAX
  functions on ``tests/test_boundaries.py``'s seeds and on a hypothesis
  sweep of segment sizes and offsets.
- The CLI's JSON bytes (``--device cpu``) equal to the egs recipe
  script's on the same ``.npy`` directory; without ``--device cpu`` the
  CLI raises here.
"""

import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.exceptions import ConvergenceWarning
from sklearn.mixture import GaussianMixture as SkGMM

from speaker3d_tpu.diar import boundaries as jb
from speaker3d_tpu_torch.cli import detect_boundaries
from speaker3d_tpu_torch.diar import boundaries as pb
from speaker3d_tpu_torch.diar.gmm import GaussianMixture
from tests.test_boundaries import _sequential_embs
from tests.torch_threads import cap_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_speakers(seed, d, spread, dtype=np.float64):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    x = np.concatenate([q[0] + spread * rng.standard_normal((25, d)),
                        q[1] + spread * rng.standard_normal((25, d))])
    return x.astype(dtype)


def _fit_both(x, k):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        want = SkGMM(k, covariance_type="diag", max_iter=100,
                     random_state=0).fit(x)
    got = GaussianMixture(k, max_iter=100, random_state=0).fit(x)
    return got, want


@pytest.mark.parametrize("d", [16, 192])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("spread,seed", [(0.05, 0), (0.05, 1), (0.5, 2),
                                         (2.0, 3)])
def test_gmm_matches_scikit_learn(d, k, spread, seed):
    """spread 0.05: two separated speakers; 0.5 and 2.0 overlap."""
    x = _two_speakers(seed, d, spread)
    got, want = _fit_both(x, k)
    assert got.converged_ == want.converged_
    a, b = np.argsort(got.means_[:, 0]), np.argsort(want.means_[:, 0])
    for name in ("weights_", "means_", "covariances_"):
        g, w = getattr(got, name)[a], getattr(want, name)[b]
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    s_got, s_want = got.score_samples(x), want.score_samples(x)
    assert s_got.dtype == s_want.dtype == np.float64
    np.testing.assert_allclose(s_got, s_want, rtol=1e-6, atol=0)


def test_gmm_keeps_float32_input_in_float32_as_scikit_learn():
    x = _two_speakers(4, 16, 0.05, np.float32)
    got, want = _fit_both(x, 2)
    assert got.means_.dtype == want.means_.dtype == np.float32
    np.testing.assert_allclose(got.score_samples(x), want.score_samples(x),
                               rtol=1e-5)


def test_gmm_refuses_what_scikit_learn_refuses():
    with pytest.raises(ValueError):
        GaussianMixture(3).fit(np.zeros((2, 4)))
    with pytest.raises(ValueError):
        GaussianMixture(1).fit(np.full((12, 4), np.nan))
    # train_speaker_gmm returns None there
    assert pb.train_speaker_gmm(np.full((12, 4), np.nan)) is None
    assert pb.train_speaker_gmm(np.zeros((9, 4))) is None


def test_boundary_refinements_equal_jax_on_the_jax_tests_seeds():
    x = _sequential_embs([57, 43])
    left_c, right_c = x[:50].mean(0), x[50:].mean(0)
    assert (pb.find_precise_boundary(x, 50, left_c, right_c)
            == jb.find_precise_boundary(x, 50, left_c, right_c))
    x = _sequential_embs([105, 95], seed=1)
    got = pb.find_precise_boundary_gmm(x, 100, boundary_window=10)
    assert got == jb.find_precise_boundary_gmm(x, 100, boundary_window=10)
    assert got[1]["method"] == "gmm"
    x = _sequential_embs([65, 70, 65], seed=2)
    for method in ("cosine", "gmm"):
        assert (pb.detect_speaker_boundaries(x, 3, method=method)
                == jb.detect_speaker_boundaries(x, 3, method=method))


@settings(max_examples=25, deadline=None)
@given(sizes=st.lists(st.integers(8, 60), min_size=2, max_size=4),
       offset=st.integers(-6, 6), seed=st.integers(0, 2**16),
       spread=st.sampled_from([0.05, 0.3]), window=st.integers(2, 12))
def test_boundaries_equal_jax_on_a_sweep(sizes, offset, seed, spread,
                                         window):
    x = _sequential_embs(sizes, seed=seed, spread=spread)
    n = len(x)
    theo = min(max(sizes[0] + offset, 1), n - 1)
    centers = pb.calculate_segment_centers(x, [theo])
    assert pb.find_precise_boundary(
        x, theo, centers[0], centers[1], window) == jb.find_precise_boundary(
        x, theo, centers[0], centers[1], window)
    assert (pb.find_precise_boundary_gmm(x, theo, boundary_window=window)
            == jb.find_precise_boundary_gmm(x, theo, boundary_window=window))
    for method in ("cosine", "gmm"):
        assert (pb.detect_speaker_boundaries(x, len(sizes), method=method,
                                             boundary_window=window)
                == jb.detect_speaker_boundaries(x, len(sizes), method=method,
                                                boundary_window=window))


def _recipe():
    spec = importlib.util.spec_from_file_location(
        "detect_boundaries_recipe",
        os.path.join(REPO, "egs", "split_sequential_speakers",
                     "detect_boundaries.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method", ["cosine", "gmm"])
def test_cli_json_equals_the_recipe_scripts_bytes(tmp_path, method):
    x = _sequential_embs([30, 25, 28], seed=3)
    emb = tmp_path / "emb"
    emb.mkdir()
    for i, e in enumerate(x):
        np.save(emb / f"utt{i:04d}.npy", e.astype(np.float32))
    want, got = tmp_path / "want.json", tmp_path / "got.json"
    assert _recipe().main(["--emb", str(emb), "--num_speakers", "3",
                           "--method", method, "--out", str(want)]) == 0
    assert detect_boundaries.main(["--emb", str(emb), "--num_speakers", "3",
                                   "--method", method, "--out", str(got),
                                   "--device", "cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_cli_needs_a_card_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # pragma: no cover
    np.save(tmp_path / "a.npy", np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="cpu"):
        detect_boundaries.main(["--emb", str(tmp_path), "--num_speakers",
                                "2"])
