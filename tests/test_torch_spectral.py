"""The PyTorch port's spectral clustering (diar/cluster.py SpectralCluster,
diar/kmeans.py) against the JAX package's, and its k-means against
scikit-learn's.

- Host stages (affinity, p-pruning, Laplacian, eigenpairs) equal to JAX's:
  arrays to 1e-12, eigenvalues to 1e-10, eigenvectors up to sign.
- Partitions equal to JAX's (up to renumbering) on the blobs of
  tests/test_cluster.py, with and without the oracle speaker count.
- The device path (float32 on ``device="cpu"``), in its eigh branch and its
  LOBPCG branch (``eigh_max_n=0``), gives the host path's partition.
- ``kmeans.k_means`` against ``sklearn.cluster.k_means`` (imported only
  here: the port runs where scikit-learn is absent) on a hypothesis sweep
  of separated data: the same partition, inertia within 1e-6 relative.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.diar import cluster as jcluster
from speaker3d_tpu_torch.diar import cluster as tcluster
from speaker3d_tpu_torch.diar.kmeans import k_means
from tests.test_cluster import _blobs, _purity


def _partition(labels):
    groups = {}
    for i, g in enumerate(np.asarray(labels).tolist()):
        groups.setdefault(g, []).append(i)
    return sorted(tuple(v) for v in groups.values())


def _spectral(pkg, **kw):
    if pkg is tcluster:
        kw.setdefault("device", "cpu")
    return pkg.SpectralCluster(**kw)


def test_host_stages_equal_jax():
    x, _ = _blobs(sizes=(25, 30, 20), seed=3, spread=0.2)
    aff_t, aff_j = tcluster.cosine_affinity(x), jcluster.cosine_affinity(x)
    np.testing.assert_array_equal(aff_t, aff_j)
    t, j = _spectral(tcluster, pval=0.1), _spectral(jcluster, pval=0.1)
    pruned_t, pruned_j = t.p_pruning(aff_t.copy()), j.p_pruning(aff_j.copy())
    np.testing.assert_array_equal(pruned_t, pruned_j)
    lap_t = t.laplacian(0.5 * (pruned_t + pruned_t.T))
    lap_j = j.laplacian(0.5 * (pruned_j + pruned_j.T))
    np.testing.assert_allclose(lap_t, lap_j, rtol=0, atol=1e-12)
    for oracle in (None, 3):
        emb_t, k_t = t.spectral_embeddings(lap_t, oracle)
        emb_j, k_j = j.spectral_embeddings(lap_j, oracle)
        assert k_t == k_j == 3
        signs = np.sign((emb_t * emb_j).sum(0))
        np.testing.assert_allclose(emb_t * signs, emb_j, atol=1e-10)
    from scipy.linalg import eigh

    lam_t = eigh(lap_t, subset_by_index=[0, 10], eigvals_only=True)
    lam_j = eigh(lap_j, subset_by_index=[0, 10], eigvals_only=True)
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize("sizes,seed,oracle", [
    ((40, 40, 40), 0, None), ((40, 40), 0, 2), ((30, 45, 25, 35), 2, None),
    ((50, 20, 35), 9, 3)])
def test_partition_equals_jax(sizes, seed, oracle):
    x, y = _blobs(sizes=sizes, seed=seed)
    got = _spectral(tcluster, pval=0.05, random_state=0)(x, speaker_num=oracle)
    want = _spectral(jcluster, pval=0.05, random_state=0)(x, speaker_num=oracle)
    assert _partition(got) == _partition(want)
    assert _purity(got, y) == 1.0
    assert len(np.unique(got)) == len(sizes)


@pytest.mark.parametrize("eigh_max_n", [2048, 0])
@pytest.mark.parametrize("sizes,seed", [((40, 40, 40), 5), ((60, 60, 60), 7),
                                        ((80, 50, 70, 60), 1)])
def test_device_path_matches_host_path(eigh_max_n, sizes, seed):
    """The eigh branch, and the LOBPCG branch (n > 5k at
    max_num_spks = 10), as the JAX package's test_spectral_jax_* tests."""
    x, y = _blobs(sizes=sizes, seed=seed)
    host = _spectral(tcluster, pval=0.05, random_state=0)(x)
    dev = tcluster.SpectralCluster(pval=0.05, backend="device",
                                   eigh_max_n=eigh_max_n, random_state=0,
                                   device="cpu")
    if eigh_max_n == 0:
        assert x.shape[0] > 5 * (dev.max_num_spks + 1)
    got = dev(x)
    assert _partition(got) == _partition(host)
    assert _purity(got, y) == 1.0


def test_device_eigenpairs_match_host():
    """Both device branches return the k smallest eigenpairs of the host's
    Laplacian (p-pruning ties aside, none here) to float32 accuracy."""
    x, _ = _blobs(sizes=(60, 60, 60), seed=7)
    sc = _spectral(tcluster, pval=0.05)
    lap = sc.laplacian(0.5 * (sc.p_pruning(tcluster.cosine_affinity(x))
                              + sc.p_pruning(tcluster.cosine_affinity(x)).T))
    from scipy.linalg import eigh

    want = eigh(lap, subset_by_index=[0, 10], eigvals_only=True)
    n_zero = sc._n_zero(x.shape[0], None)
    for lobpcg in (False, True):
        lam, vecs = tcluster.spectral_eigenpairs(x, n_zero, 11, lobpcg, "cpu")
        assert lam.shape == (11,) and vecs.shape == (180, 11)
        np.testing.assert_allclose(lam, want, atol=2e-3 * want.max())


def test_small_n_device_path_takes_eigh():
    """Below 5k rows the device path takes the dense eigh even with
    eigh_max_n = 0 (k = 16 at max_num_spks = 15)."""
    x, y = _blobs(sizes=(30, 30), seed=11)
    lab = tcluster.SpectralCluster(pval=0.05, max_num_spks=15,
                                   backend="device", eigh_max_n=0,
                                   device="cpu")(x)
    assert _purity(lab, y) == 1.0
    assert len(np.unique(lab)) == 2


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        tcluster.SpectralCluster(backend="jax", device="cpu")


def _separated(seed, n_clusters, dim, n_per):
    """Unit-variance blobs whose centres lie 12 apart along a random
    direction (with random offsets across it): every pair of clusters is
    separated whatever the dimension."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(dim)
    u /= np.linalg.norm(u)
    offsets = 3.0 * rng.standard_normal((n_clusters, dim))
    offsets -= np.outer(offsets @ u, u)
    centers = 12.0 * np.arange(n_clusters)[:, None] * u + offsets
    sizes = rng.integers(n_per // 2, n_per + 1, n_clusters)
    x = np.concatenate([c + rng.standard_normal((m, dim))
                        for c, m in zip(centers, sizes)])
    return x


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(1, 6),
       dim=st.integers(1, 12), n_per=st.integers(4, 40))
def test_kmeans_matches_sklearn(seed, k, dim, n_per):
    from sklearn.cluster import k_means as sk_k_means

    x = _separated(seed, k, dim, n_per)
    labels, inertia = k_means(x, k, n_init=10, random_state=seed)
    _, sk_labels, sk_inertia = sk_k_means(x, k, n_init=10, random_state=seed)
    assert _partition(labels) == _partition(sk_labels)
    assert abs(inertia - sk_inertia) <= 1e-6 * max(sk_inertia, 1e-300)


def test_kmeans_seeds():
    """None draws from numpy's global RNG (seeding it reproduces the call,
    and the call advances it); an int seeds a private generator and leaves
    the global RNG alone."""
    x = np.random.default_rng(0).standard_normal((60, 3))  # init matters
    saved = np.random.get_state()
    try:
        np.random.seed(123)
        seeded = np.random.get_state()[1].copy()
        first = k_means(x, 4, n_init=1)[0]
        assert np.random.get_state()[2] != 0 or not np.array_equal(
            np.random.get_state()[1], seeded)
        np.random.seed(123)
        assert np.array_equal(k_means(x, 4, n_init=1)[0], first)
        before = np.random.get_state()
        a = k_means(x, 4, n_init=1, random_state=5)[0]
        b = k_means(x, 4, n_init=1, random_state=5)[0]
        assert np.array_equal(a, b)
        after = np.random.get_state()
        assert np.array_equal(after[1], before[1]) and after[2] == before[2]
    finally:
        np.random.set_state(saved)
