"""The PyTorch port's UMAP+HDBSCAN clustering (diar/umap_native.py,
diar/hdbscan_native.py, diar/cluster.py UmapHdbscan) against the JAX
package's.

- ``hdbscan_labels`` bit-equal to JAX's on several seeds, noise points and
  dissolved small groups included.
- The UMAP host stages (``find_ab_params``, ``smooth_knn_dist``,
  ``fuzzy_simplicial_set``, ``spectral_init``) equal to JAX's at 1e-6.
- The layout (torch on ``device="cpu"``; its random stream is torch's, not
  JAX's, so layouts differ numerically) keeps the blob structure, and
  ``UmapHdbscan`` gives JAX's partition on separated blobs.
- The ``CommonClustering`` dispatch for spectral and UMAP+HDBSCAN, and
  ``backend="external"`` raising without the packages, as in JAX.
"""

import numpy as np
import pytest
import torch

from speaker3d_tpu.diar import cluster as jcluster
from speaker3d_tpu.diar import hdbscan_native as jhdb
from speaker3d_tpu.diar import umap_native as jumap
from speaker3d_tpu_torch.diar import cluster as tcluster
from speaker3d_tpu_torch.diar import hdbscan_native as thdb
from speaker3d_tpu_torch.diar import umap_native as tumap
from tests.test_umap_hdbscan import _blobs, _purity
from tests.torch_threads import cap_torch_threads  # noqa: F401


def _partition(labels):
    groups = {}
    for i, g in enumerate(np.asarray(labels).tolist()):
        groups.setdefault(g, []).append(i)
    return sorted(tuple(v) for v in groups.values())


def _data(seed):
    """Blobs of several sizes and spreads, uniform outliers, and a tight
    group smaller than min_cluster_size."""
    rng = np.random.default_rng(seed)
    dim = 6
    big, _ = _blobs(rng, rng.normal(0, 4, (3, dim)), 40, dim, scale=0.3)
    tiny = rng.normal(-9.0, 0.05, (4, dim))
    noise = rng.uniform(-10, 10, (10, dim))
    return np.concatenate([big, tiny, noise])


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("min_samples,min_cluster_size", [(5, 10), (3, 8)])
def test_hdbscan_labels_bit_equal_jax(seed, min_samples, min_cluster_size):
    x = _data(seed)
    got = thdb.hdbscan_labels(x, min_samples=min_samples,
                              min_cluster_size=min_cluster_size)
    want = jhdb.hdbscan_labels(x, min_samples=min_samples,
                               min_cluster_size=min_cluster_size)
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and len(set(got) - {-1}) >= 2
    assert np.all(got[120:124] == -1)  # the tiny group dissolves into noise


def test_hdbscan_degenerate_inputs_equal_jax():
    x = np.random.default_rng(3).normal(0, 1, (3, 4))
    np.testing.assert_array_equal(thdb.hdbscan_labels(x, min_cluster_size=5),
                                  jhdb.hdbscan_labels(x, min_cluster_size=5))
    assert thdb.hdbscan_labels(np.empty((0, 4))).shape == (0,)


def test_umap_host_stages_equal_jax():
    rng = np.random.default_rng(0)
    x, _ = _blobs(rng, rng.normal(0, 1, (3, 16)) * 4.0, 30, 16, scale=0.3)
    for spread, min_dist in ((1.0, 0.0), (1.0, 0.1), (2.0, 0.5)):
        np.testing.assert_allclose(tumap.find_ab_params(spread, min_dist),
                                   jumap.find_ab_params(spread, min_dist),
                                   rtol=1e-6, atol=1e-6)
    dist = thdb.pairwise_euclidean(x)
    np.testing.assert_array_equal(dist, jhdb.pairwise_euclidean(x))
    knn = np.sort(dist, axis=1)[:, :15]
    for got, want in zip(tumap.smooth_knn_dist(knn, 15),
                         jumap.smooth_knn_dist(knn, 15)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    graph_t = tumap.fuzzy_simplicial_set(dist, 15)
    graph_j = jumap.fuzzy_simplicial_set(dist, 15)
    for got, want in zip(graph_t, graph_j):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rows, cols, vals = graph_t
    np.testing.assert_allclose(
        tumap.spectral_init(rows, cols, vals, len(x), 4, seed=3),
        jumap.spectral_init(rows, cols, vals, len(x), 4, seed=3),
        rtol=1e-6, atol=1e-6)


def test_layout_preserves_blob_structure():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1, (3, 32)) * 4.0
    x, true = _blobs(rng, centers, 50, 32, scale=0.2)
    y = tumap.umap_embed(x, n_neighbors=15, n_components=2, min_dist=0.0,
                         n_epochs=150, seed=0, device="cpu")
    assert y.shape == (150, 2) and y.dtype == np.float32
    assert np.all(np.isfinite(y))
    within, across = [], []
    for i in range(3):
        m = y[true == i]
        within.append(np.linalg.norm(m - m.mean(0), axis=1).mean())
        for j in range(i + 1, 3):
            across.append(np.linalg.norm(m.mean(0) - y[true == j].mean(0)))
    assert min(across) > 2.0 * max(within)
    # the layout is a function of the seed
    again = tumap.umap_embed(x, n_neighbors=15, n_components=2, min_dist=0.0,
                             n_epochs=150, seed=0, device="cpu")
    np.testing.assert_array_equal(y, again)


def test_optimize_layout_order_of_updates():
    """One epoch with every edge sampled and one negative: the attraction
    moves heads then tails, the repulsion reads each negative after the
    attraction, as the JAX loop does (a numpy loop of the same order)."""
    rng = np.random.default_rng(1)
    y0 = rng.normal(0, 1, (6, 2)).astype(np.float32)
    heads = np.array([0, 1, 2, 0, 4])
    tails = np.array([1, 2, 3, 5, 5])
    a, b = 1.5, 0.9
    gen = torch.Generator().manual_seed(0)
    got = tumap.optimize_layout(
        torch.from_numpy(y0), torch.from_numpy(heads), torch.from_numpy(tails),
        torch.ones(5), a, b, 1, 1, gen).numpy()
    gen = torch.Generator().manual_seed(0)
    torch.rand(5, generator=gen)  # the edge mask's draw
    neg = torch.randint(0, 6, (5, 1), generator=gen).numpy()[:, 0]
    y = y0.astype(np.float64)
    diff = y[heads] - y[tails]
    d2 = np.maximum((diff * diff).sum(1, keepdims=True), 1e-12)
    g = np.clip(-2 * a * b * d2 ** (b - 1) / (1 + a * d2 ** b) * diff, -4, 4)
    np.add.at(y, heads, g)
    np.add.at(y, tails, -g)
    diff_n = y[heads] - y[neg]
    d2n = (diff_n * diff_n).sum(1, keepdims=True)
    rep = 2 * b / ((0.001 + d2n) * (1 + a * np.maximum(d2n, 1e-12) ** b))
    np.add.at(y, heads, np.where(d2n > 0, np.clip(rep * diff_n, -4, 4), 4.0))
    np.testing.assert_allclose(got, y, rtol=1e-5, atol=1e-5)


def test_umap_hdbscan_partition_equals_jax():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 1, (4, 192))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x, true = _blobs(rng, centers * 8.0, 40, 192, scale=0.4)
    kw = dict(n_neighbors=15, n_components=8, min_samples=10,
              min_cluster_size=10)
    got = tcluster.UmapHdbscan(device="cpu", **kw)(x)
    want = jcluster.UmapHdbscan(**kw)(x)
    assert _partition(got) == _partition(want)
    assert len(set(got) - {-1}) == 4 and _purity(got, true) > 0.9


@pytest.mark.parametrize("kind,kw", [
    ("umap_hdbscan", dict(n_neighbors=15, n_components=8, min_samples=8)),
    ("spectral", dict(pval=0.05, random_state=0))])
def test_common_clustering_dispatch_equals_jax(kind, kw):
    rng = np.random.default_rng(1)
    centers = np.eye(64)[:3] * 6.0
    x, true = _blobs(rng, centers, 40, 64, scale=0.3)
    common = dict(cluster_line=40, mer_cos=0.9, min_cluster_size=4)
    got = tcluster.CommonClustering(kind, device="cpu", **common, **kw)(x)
    want = jcluster.CommonClustering(kind, **common, **kw)(x)
    assert _partition(got) == _partition(want)
    assert len(np.unique(got)) == 3 and _purity(got, true) > 0.9
    # below cluster_line both hand the input to AHC
    short = x[::4]
    np.testing.assert_array_equal(
        tcluster.CommonClustering(kind, device="cpu", **common, **kw)(short),
        jcluster.CommonClustering(kind, **common, **kw)(short))


def test_external_backend_unavailable_raises():
    with pytest.raises(ImportError):
        tcluster.UmapHdbscan(backend="external", device="cpu")(
            np.zeros((50, 8)))
    with pytest.raises(ImportError):
        jcluster.UmapHdbscan(backend="external")(np.zeros((50, 8)))


def test_label_helpers_equal_jax():
    labels = [5, 5, 2, 7, 2]
    np.testing.assert_array_equal(tcluster.arrange_labels(labels),
                                  jcluster.arrange_labels(labels))
    np.testing.assert_array_equal(tcluster.arrange_labels([1, 0], start=3),
                                  [3, 4])
    times = [[0, 1], [0.5, 2], [3, 4], [4, 5]]
    assert (tcluster.merge_consecutive([list(t) for t in times])
            == jcluster.merge_consecutive([list(t) for t in times]))
