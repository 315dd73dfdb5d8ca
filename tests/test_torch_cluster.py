"""The PyTorch port's clustering (diar/cluster.py, diar/ahc_nnchain.py)
against the JAX package's."""

import numpy as np
import pytest
import torch

from speaker3d_tpu.diar import ahc_nnchain as jnn
from speaker3d_tpu.diar.cluster import CommonClustering as JaxCommon
from speaker3d_tpu_torch.diar import ahc_nnchain as tnn
from speaker3d_tpu_torch.diar.cluster import AHCluster, CommonClustering


def _embs(rng, n, n_spk=5, d=32, noise=0.15):
    centers = rng.standard_normal((n_spk, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_spk, n)
    return (centers[lab] + noise * rng.standard_normal((n, d))).astype(
        np.float32)


def _partition(labels):
    groups = {}
    for i, g in enumerate(labels):
        groups.setdefault(int(g), []).append(i)
    return sorted(tuple(v) for v in groups.values())


@pytest.mark.parametrize("n", [12, 39, 40, 150])
def test_common_clustering_ahc_labels_equal_jax(n):
    """Both sides of cluster_line=40, with the pipeline's settings."""
    rng = np.random.default_rng(n)
    x = _embs(rng, n, noise=0.6)
    kw = dict(mer_cos=0.3, fix_cos_thr=0.3, min_cluster_size=0)
    ours = CommonClustering("AHC", device="cpu", **kw)(x)
    theirs = JaxCommon("AHC", **kw)(x)
    np.testing.assert_array_equal(ours, theirs)
    for ratio in (None, 0.1):
        kw = dict(mer_cos=0.5, fix_cos_thr=0.5, min_cluster_size=2,
                  min_cluster_ratio=ratio)
        np.testing.assert_array_equal(
            CommonClustering("AHC", device="cpu", **kw)(x),
            JaxCommon("AHC", **kw)(x))


@pytest.mark.parametrize("backend", ["numpy", "device", "nnchain",
                                     "nnchain_device"])
def test_ahc_backends_same_partition(backend):
    x = _embs(np.random.default_rng(7), 300, n_spk=6)
    want = AHCluster(fix_cos_thr=0.4, backend="numpy", device="cpu")(x)
    got = AHCluster(fix_cos_thr=0.4, backend=backend, device="cpu")(x)
    assert _partition(got) == _partition(want)


@pytest.mark.parametrize("n", [50, 600])
def test_torch_nnchain_on_cpu_matches_float64_host(n):
    x = _embs(np.random.default_rng(11), n, n_spk=8, d=64)
    for thr in (0.2, 0.4, 0.6):
        dev = tnn.device_linkage_labels(x, thr, device="cpu")
        host = jnn.linkage_labels(x, thr)
        assert _partition(dev) == _partition(host), thr
        np.testing.assert_array_equal(tnn.linkage_labels(x, thr), host)


def test_nnchain_merges_equal_jax_host():
    x = _embs(np.random.default_rng(12), 80)
    for got, want in zip(tnn.nn_chain_merges(x), jnn.nn_chain_merges(x)):
        np.testing.assert_array_equal(got, want)
    assert tnn.device_linkage_labels(x[:1], 0.3, device="cpu").tolist() == [0]


def test_auto_cutover_asks_the_port_device():
    assert AHCluster(device="cpu")._resolve_backend(5000) == "numpy"
    assert AHCluster(device="cpu")._resolve_backend(30000) == "nnchain"
    assert AHCluster(device="cpu")._resolve_backend(100) == "numpy"


def test_unported_cluster_types_raise():
    """Spectral and UMAP+HDBSCAN are ported (tests/test_torch_spectral.py,
    tests/test_torch_umap_hdbscan.py); a type the JAX package lacks is
    refused."""
    for kind in ("spectral", "umap_hdbscan"):
        assert CommonClustering(kind, device="cpu").cluster_type == kind
    with pytest.raises(ValueError):
        CommonClustering("kmeans", device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only default")
    with pytest.raises(RuntimeError, match="CUDA"):
        AHCluster()


def test_auto_cutover_warns_once_per_process(caplog, monkeypatch):
    """Two ``auto`` calls above the cut-over log one warning, as the JAX
    AHCluster latches it (a batch run over long files logs it once)."""
    monkeypatch.setattr(AHCluster, "_cutover_warned", False)
    x = _embs(np.random.default_rng(13), 40)
    ahc = AHCluster(fix_cos_thr=0.4, auto_nnchain_n=8, cpu_scipy_max_n=16,
                    device="cpu")
    with caplog.at_level("WARNING", logger="speaker3d_tpu_torch"):
        first = ahc(x)
        second = AHCluster(fix_cos_thr=0.4, auto_nnchain_n=8,
                           cpu_scipy_max_n=16, device="cpu")(x)
    warnings = [r for r in caplog.records if "AHC auto backend" in r.message]
    assert len(warnings) == 1 and "nnchain" in warnings[0].message
    assert _partition(first) == _partition(second) == _partition(
        AHCluster(fix_cos_thr=0.4, backend="numpy", device="cpu")(x))
