"""Clustering for diarization: AHC and the common post-processing.

The counterpart of the AHC half of ``speaker3d_tpu/diar/cluster.py``:
``AHCluster`` (average linkage on -cosine, cut at a fixed cosine threshold)
and ``CommonClustering`` (short-input path below ``cluster_line``,
minor-cluster reassignment, iterative centroid cosine merging). Spectral and
UMAP+HDBSCAN clustering are not ported yet (ROADMAP.md, M11).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device

NOT_PORTED = "not ported to the PyTorch package yet (ROADMAP.md, M11)"


def l2_normalize(x, axis=-1, eps=1e-12):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def cosine_affinity(x, y=None):
    xn = l2_normalize(np.asarray(x, dtype=np.float64))
    yn = xn if y is None else l2_normalize(np.asarray(y, dtype=np.float64))
    return xn @ yn.T


class AHCluster:
    """Average-linkage AHC cut at a fixed cosine threshold.

    Backends:
      - 'numpy': exact scipy linkage over the condensed float64 -cos matrix
        (O(N^2) memory);
      - 'device': the same scipy linkage with the O(N^2 d) affinity computed
        on ``device`` in float32;
      - 'nnchain': host NN-chain over (sum-vector, size) clusters, float64,
        O(N d) memory, same dendrogram;
      - 'nnchain_device': the NN-chain with the cluster sums on ``device``
        (float32);
      - 'auto' (default): scipy up to ``auto_nnchain_n`` rows; above it the
        device NN-chain when ``device`` is a CUDA device, else scipy up to
        ``cpu_scipy_max_n`` rows and the host NN-chain past that.
    """

    def __init__(self, fix_cos_thr=0.4, backend: str = "auto",
                 auto_nnchain_n: int = 4096, cpu_scipy_max_n: int = 24576,
                 device=DEFAULT_DEVICE):
        self.fix_cos_thr = fix_cos_thr
        self.backend = backend
        self.auto_nnchain_n = auto_nnchain_n
        self.cpu_scipy_max_n = cpu_scipy_max_n
        self.device = resolve_device(device)

    def _resolve_backend(self, n):
        if self.backend != "auto":
            return self.backend
        if n <= self.auto_nnchain_n:
            return "numpy"
        if self.device.type == "cuda":
            self._warn_cutover(n, "nnchain_device (float32 affinity)")
            return "nnchain_device"
        if n <= self.cpu_scipy_max_n:
            return "numpy"
        self._warn_cutover(n, "nnchain (float64, O(N d) memory)")
        return "nnchain"

    # set by the first cut-over warning: a batch run over many long files
    # logs it once per process, not once per file
    _cutover_warned = False

    def _warn_cutover(self, n, chosen):
        if AHCluster._cutover_warned:
            return
        AHCluster._cutover_warned = True
        logging.getLogger("speaker3d_tpu_torch").warning(
            "AHC auto backend: N=%d > %d, switching scipy -> %s; near-tie "
            "merge order may differ from the reference's exact float64 "
            "dendrogram (pass backend='numpy' to force exact parity)",
            n, self.auto_nnchain_n, chosen)

    def __call__(self, X, **kwargs):
        from scipy.cluster.hierarchy import fcluster, linkage
        from scipy.spatial.distance import squareform

        from speaker3d_tpu_torch.diar import ahc_nnchain

        backend = self._resolve_backend(np.asarray(X).shape[0])
        if backend == "nnchain_device":
            return ahc_nnchain.device_linkage_labels(X, self.fix_cos_thr,
                                                     device=self.device)
        if backend == "nnchain":
            return ahc_nnchain.linkage_labels(X, self.fix_cos_thr)
        if backend == "device":
            x = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
            xn = torch.nn.functional.normalize(x, dim=1, eps=1e-12)
            aff = (xn @ xn.T).double().cpu().numpy()
            aff = 0.5 * (aff + aff.T)  # exact symmetry for squareform
            np.fill_diagonal(aff, 1.0)
        elif backend == "numpy":
            aff = cosine_affinity(X)
        else:
            raise ValueError(f"unknown AHC backend {backend!r}")
        scr = squareform(-aff, checks=False)
        lin = linkage(scr, method="average")
        adjust = abs(lin[:, 2].min())
        lin[:, 2] += adjust
        return fcluster(lin, -self.fix_cos_thr + adjust,
                        criterion="distance") - 1


class CommonClustering:
    """Dispatcher + cluster post-processing."""

    def __init__(self, cluster_type, cluster_line=40, mer_cos=None,
                 min_cluster_size=4, min_cluster_ratio=None,
                 device=DEFAULT_DEVICE, **kwargs):
        """``min_cluster_ratio``: optional relative minimum cluster size; the
        minor-cluster threshold becomes max(min_cluster_size,
        ceil(ratio * num_chunks))."""
        if cluster_type in ("spectral", "umap_hdbscan"):
            raise NotImplementedError(f"cluster_type {cluster_type!r} is "
                                      f"{NOT_PORTED}")
        if cluster_type != "AHC":
            raise ValueError(f"{cluster_type} is not currently supported.")
        self.cluster_type = cluster_type
        self.cluster_line = cluster_line
        self.min_cluster_size = min_cluster_size
        self.min_cluster_ratio = min_cluster_ratio
        self.mer_cos = mer_cos
        self.cluster = AHCluster(device=device, **kwargs)

    def __call__(self, X, **kwargs):
        if X.ndim != 2:
            raise ValueError(f"embeddings must be [N, C], got {X.shape}")
        if X.shape[0] <= 1:
            return np.zeros(X.shape[0], dtype=int)
        # inputs shorter than cluster_line go to the short-input clusterer,
        # which for AHC is this same AHCluster
        labels = np.asarray(self.cluster(X, **kwargs)).copy()
        min_size = self.min_cluster_size
        if self.min_cluster_ratio is not None:
            min_size = max(min_size,
                           int(np.ceil(self.min_cluster_ratio * X.shape[0])))
        labels = self.filter_minor_cluster(labels, X, min_size)
        if self.mer_cos is not None:
            labels = self.merge_by_cos(labels, X, self.mer_cos)
        return labels

    def filter_minor_cluster(self, labels, x, min_cluster_size):
        """Reassign members of clusters of size <= min_cluster_size to the
        nearest (cosine) major-cluster centroid."""
        cset = np.unique(labels)
        csize = np.array([(labels == i).sum() for i in cset])
        minor = cset[csize <= min_cluster_size]
        if len(minor) == 0:
            return labels
        major = cset[csize > min_cluster_size]
        if len(major) == 0:
            return np.zeros_like(labels)
        centers = np.stack([x[labels == i].mean(0) for i in major])
        minor_mask = np.isin(labels, minor)
        sims = cosine_affinity(x[minor_mask], centers)
        labels[minor_mask] = major[np.argmax(sims, axis=1)]
        return labels

    def merge_by_cos(self, labels, x, cos_thr):
        """Iteratively merge the centroid pair with max cosine >= threshold."""
        if not 0 < cos_thr <= 1:
            raise ValueError(f"mer_cos must be in (0, 1], got {cos_thr}")
        while True:
            cset = np.unique(labels)
            if len(cset) == 1:
                break
            centers = np.stack([x[labels == i].mean(0) for i in cset])
            aff = np.triu(cosine_affinity(centers), 1)
            idx = np.unravel_index(np.argmax(aff), aff.shape)
            if aff[idx] < cos_thr:
                break
            c1, c2 = cset[list(idx)]
            labels[labels == c2] = c1
        return labels
