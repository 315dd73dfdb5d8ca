"""Clustering backends for diarization.

The counterpart of ``speaker3d_tpu/diar/cluster.py``:
  - ``SpectralCluster``: cosine affinity -> p-pruning -> symmetrise ->
    unnormalised Laplacian -> smallest eigenpairs -> eigengap speaker count
    -> k-means on the spectral embeddings (``diar/kmeans.py``);
  - ``AHCluster``: average linkage on -cosine, cut at a fixed cosine
    threshold;
  - ``UmapHdbscan``: UMAP -> HDBSCAN (``umap-learn``/``hdbscan`` when both
    import, else ``diar/umap_native.py`` with its layout on the device and
    ``diar/hdbscan_native.py``);
  - ``CommonClustering``: the dispatcher (inputs shorter than
    ``cluster_line`` go to AHC), minor-cluster reassignment and iterative
    centroid cosine merging.

Labels, linkage, eigengap and k-means stay on the host; the device paths
compute the affinity, the Laplacian's eigenpairs and the UMAP layout on
``device``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision


def l2_normalize(x, axis=-1, eps=1e-12):
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def cosine_affinity(x, y=None):
    xn = l2_normalize(np.asarray(x, dtype=np.float64))
    yn = xn if y is None else l2_normalize(np.asarray(y, dtype=np.float64))
    return xn @ yn.T


def spectral_eigenpairs(x, n_zero: int, k: int, use_lobpcg: bool, device):
    """Affinity -> p-prune -> Laplacian -> the k smallest eigenpairs, in
    float32 on ``device`` with TF32 off; only the k pairs reach the host.

    p-pruning keeps ``sim >= sort(sim)[:, n_zero]`` per row (ties at the
    threshold all stay, unlike the host path's argsort). ``use_lobpcg``:
    ``torch.lobpcg`` for the k largest eigenpairs of ``c*I - L`` (Gershgorin
    bound c = 2 max(deg) + 1; at most 200 iterations, started from a
    generator seeded 0) instead of a dense ``torch.linalg.eigh``."""
    with torch.no_grad(), matmul_precision("highest"):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        xn = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        sim = xn @ xn.T
        if n_zero > 0:
            thr = torch.sort(sim, dim=1).values[:, n_zero:n_zero + 1]
            sim = torch.where(sim >= thr, sim, torch.zeros_like(sim))
        sim = 0.5 * (sim + sim.T)
        sim.fill_diagonal_(0.0)
        deg = sim.abs().sum(dim=1)
        lap = torch.diag(deg) - sim
        if use_lobpcg:
            n = x.shape[0]
            c = 2.0 * deg.max() + 1.0
            gen = torch.Generator(device=device).manual_seed(0)
            x0 = torch.randn((n, k), generator=gen, device=device)
            shifted = c * torch.eye(n, device=device) - lap
            theta, vecs = torch.lobpcg(shifted, k=k, X=x0, niter=200,
                                       largest=True)
            lambdas = c - theta  # largest of c*I - L = smallest of L
            order = torch.argsort(lambdas)
            lambdas, vecs = lambdas[order], vecs[:, order]
        else:
            lambdas, vecs = torch.linalg.eigh(lap)
            lambdas, vecs = lambdas[:k], vecs[:, :k]
        return lambdas.cpu().numpy(), vecs.cpu().numpy()


class SpectralCluster:
    """Spectral clustering with an eigengap speaker count.

    ``backend``: 'numpy' (float64 numpy/scipy on the host) or 'device' (the
    JAX package's 'jax': affinity, p-pruning, Laplacian and eigenpairs in
    float32 on ``device``, ``spectral_eigenpairs``; a dense eigh up to
    ``eigh_max_n`` rows, LOBPCG above it when n > 5k). The eigengap count
    and the k-means stay on the host in both. ``random_state``: the
    k-means seed; None draws from numpy's global RNG (the reference's
    behaviour, so labels of near-tie splits may change run to run)."""

    def __init__(self, min_num_spks=1, max_num_spks=10, pval=0.02, min_pnum=6,
                 oracle_num=None, backend: str = "numpy",
                 eigh_max_n: int = 2048, random_state=None,
                 device=DEFAULT_DEVICE):
        if backend not in ("numpy", "device"):
            raise ValueError(f"unknown spectral backend {backend!r}")
        self.min_num_spks = min_num_spks
        self.max_num_spks = max_num_spks
        self.min_pnum = min_pnum
        self.pval = pval
        self.k = oracle_num
        self.backend = backend
        self.eigh_max_n = eigh_max_n
        self.random_state = random_state
        self.device = resolve_device(device)

    def __call__(self, X, pval=None, speaker_num=None, **kwargs):
        if self.backend == "device":
            lambdas, vecs = self._device_spectral(X, pval)
            k_oracle = speaker_num if speaker_num is not None else self.k
            if k_oracle is not None:
                num_spk = k_oracle
            else:
                gaps = np.diff(
                    lambdas[self.min_num_spks - 1:self.max_num_spks + 1])
                num_spk = int(np.argmax(gaps)) + self.min_num_spks
            return self.kmeans(vecs[:, :num_spk], num_spk, self.random_state)
        sim = cosine_affinity(X)
        sim = self.p_pruning(sim, pval)
        sim = 0.5 * (sim + sim.T)
        lap = self.laplacian(sim)
        emb, num_spk = self.spectral_embeddings(lap, speaker_num)
        return self.kmeans(emb, num_spk, self.random_state)

    def _n_zero(self, n, pval):
        if pval is None:
            pval = self.pval
        return min(int((1 - pval) * n), n - self.min_pnum)

    def _device_spectral(self, X, pval=None):
        n = X.shape[0]
        k = min(self.max_num_spks + 1, n)
        use_lobpcg = n > self.eigh_max_n and n > 5 * k
        return spectral_eigenpairs(X, max(self._n_zero(n, pval), 0), k,
                                   use_lobpcg, self.device)

    def p_pruning(self, A, pval=None):
        """Zero the lowest (1-p) fraction of each row (keeping >= min_pnum)."""
        n = A.shape[0]
        n_zero = self._n_zero(n, pval)
        if n_zero <= 0:
            return A
        order = np.argsort(A, axis=1)
        rows = np.arange(n)[:, None]
        A[rows, order[:, :n_zero]] = 0.0
        return A

    @staticmethod
    def laplacian(M):
        M = M.copy()
        np.fill_diagonal(M, 0.0)
        D = np.diag(np.sum(np.abs(M), axis=1))
        return D - M

    def spectral_embeddings(self, L, k_oracle=None):
        from scipy.linalg import eigh

        if k_oracle is None:
            k_oracle = self.k
        k = min(self.max_num_spks + 1, L.shape[0])
        lambdas, vecs = eigh(L, subset_by_index=[0, k - 1])
        if k_oracle is not None:
            num_spk = k_oracle
        else:
            gaps = np.diff(lambdas[self.min_num_spks - 1:self.max_num_spks + 1])
            num_spk = int(np.argmax(gaps)) + self.min_num_spks
        return vecs[:, :num_spk], num_spk

    @staticmethod
    def kmeans(emb, k, random_state=None):
        from speaker3d_tpu_torch.diar.kmeans import k_means

        labels, _ = k_means(emb, k, n_init=10, random_state=random_state)
        return labels


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


class UmapHdbscan:
    """UMAP dimension reduction, then HDBSCAN density clustering.

    ``backend='auto'`` takes the ``umap-learn``/``hdbscan`` packages when
    both import (as the JAX package does), else the native path:
    ``umap_native.umap_embed`` with its layout optimised on ``device`` and
    ``hdbscan_native.hdbscan_labels`` on the host. The card's machine has
    neither package, so there it is the native path. 'external' raises
    ``ImportError`` without them; 'native' never tries them."""

    def __init__(self, n_neighbors=20, n_components=60, min_samples=20,
                 min_cluster_size=10, metric="euclidean", backend="auto",
                 device=DEFAULT_DEVICE):
        if backend not in ("auto", "external", "native"):
            raise ValueError(f"unknown UMAP+HDBSCAN backend {backend!r}")
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_samples = min_samples
        self.min_cluster_size = min_cluster_size
        self.metric = metric
        self.backend = backend
        self.device = resolve_device(device)

    def __call__(self, X, **kwargs):
        n_components = min(self.n_components, X.shape[0] - 2)
        if self.backend in ("auto", "external"):
            try:
                import hdbscan
                import umap

                # a module of that name that is not umap-learn/hdbscan
                # (a stub, a namespace collision) does not count
                if not (hasattr(umap, "UMAP") and hasattr(hdbscan, "HDBSCAN")):
                    raise ImportError(
                        "umap/hdbscan modules lack UMAP/HDBSCAN classes "
                        "(not umap-learn/hdbscan)")
            except ImportError:
                if self.backend == "external":
                    raise
            else:
                umap_x = umap.UMAP(
                    n_neighbors=self.n_neighbors, min_dist=0.0,
                    n_components=n_components,
                    metric=self.metric).fit_transform(X)
                return hdbscan.HDBSCAN(
                    min_samples=self.min_samples,
                    min_cluster_size=self.min_cluster_size).fit_predict(umap_x)
        from speaker3d_tpu_torch.diar.hdbscan_native import hdbscan_labels
        from speaker3d_tpu_torch.diar.umap_native import umap_embed

        umap_x = umap_embed(
            X, n_neighbors=self.n_neighbors, min_dist=0.0,
            n_components=n_components, metric=self.metric, device=self.device)
        return hdbscan_labels(umap_x, min_samples=self.min_samples,
                              min_cluster_size=self.min_cluster_size)


class CommonClustering:
    """Dispatcher + cluster post-processing."""

    def __init__(self, cluster_type, cluster_line=40, mer_cos=None,
                 min_cluster_size=4, min_cluster_ratio=None,
                 device=DEFAULT_DEVICE, **kwargs):
        """``min_cluster_ratio``: optional relative minimum cluster size; the
        minor-cluster threshold becomes max(min_cluster_size,
        ceil(ratio * num_chunks)). ``device`` goes to every backend's device
        path."""
        self.cluster_type = cluster_type
        self.cluster_line = cluster_line
        self.min_cluster_size = min_cluster_size
        self.min_cluster_ratio = min_cluster_ratio
        self.mer_cos = mer_cos
        if cluster_type == "spectral":
            self.cluster = SpectralCluster(device=device, **kwargs)
        elif cluster_type == "umap_hdbscan":
            kwargs["min_cluster_size"] = min_cluster_size
            self.cluster = UmapHdbscan(device=device, **kwargs)
        elif cluster_type == "AHC":
            self.cluster = AHCluster(device=device, **kwargs)
        else:
            raise ValueError(f"{cluster_type} is not currently supported.")
        self.cluster_for_short = (AHCluster(device=device)
                                  if cluster_type != "AHC" else self.cluster)

    def __call__(self, X, **kwargs):
        if X.ndim != 2:
            raise ValueError(f"embeddings must be [N, C], got {X.shape}")
        if X.shape[0] <= 1:
            return np.zeros(X.shape[0], dtype=int)
        if X.shape[0] < self.cluster_line:
            labels = self.cluster_for_short(X)
        else:
            labels = self.cluster(X, **kwargs)
        labels = np.asarray(labels).copy()
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


def merge_consecutive(times):
    """Merge overlapping/adjacent [st, ed] intervals (assumed sorted)."""
    if len(times) == 0:
        return times
    out = []
    for iv in times:
        if not out or out[-1][1] < iv[0]:
            out.append(list(iv))
        else:
            out[-1][1] = max(out[-1][1], iv[1])
    return out


def arrange_labels(labels, start=0):
    """Relabel in order of first appearance starting at ``start``."""
    mapping = {}
    out = []
    idx = start
    for lab in labels:
        if lab not in mapping:
            mapping[lab] = idx
            idx += 1
        out.append(mapping[lab])
    return np.array(out)
