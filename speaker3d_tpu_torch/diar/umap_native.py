"""Native UMAP embedding, with its layout optimised on the device.

The counterpart of ``speaker3d_tpu/diar/umap_native.py`` (UMAP as the
reference's UmapHdbscan backend runs it: ``umap.UMAP(n_neighbors,
min_dist=0.0, n_components, metric).fit_transform``):

  1. exact k-NN graph from one O(N^2) distance matrix,
  2. fuzzy simplicial set: per-point rho and sigma (bisection to
     sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k)), then the probabilistic
     t-conorm P = W + W^T - W o W^T,
  3. spectral initialisation from the symmetric normalised Laplacian,
  4. the (a, b) curve parameters fitted from (spread, min_dist),
  5. the force-directed layout: attraction along graph edges, repulsion
     against negative samples, a linearly decaying learning rate.

Steps 1-4 run on the host in float64 numpy/scipy, as in the JAX package.
Step 5 (``optimize_layout``) runs in float32 on ``device`` as gathers and
``index_add_`` in the JAX loop's order: per-edge Bernoulli masks with p
proportional to the edge weight stand in for umap's per-edge epoch
schedule, so every epoch is one fixed-shape batch of updates. Its
randomness comes from a ``torch.Generator`` on ``device`` seeded with
``seed``; JAX's PRNG stream cannot be reproduced, so the port's layouts
differ numerically from the JAX package's while optimising the same
objective.
"""

from __future__ import annotations

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar.hdbscan_native import pairwise_euclidean

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3


def find_ab_params(spread: float = 1.0, min_dist: float = 0.0):
    """Least-squares fit of 1/(1 + a*x^(2b)) to the fuzzy membership target
    (1 for x < min_dist, exp(-(x - min_dist)/spread) beyond)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv)
    return float(a), float(b)


def smooth_knn_dist(knn_dists: np.ndarray, k: int, n_iter: int = 64):
    """Per-row (rho, sigma): rho = nearest nonzero neighbour distance; sigma
    solves sum_j exp(-max(0, d_j - rho)/sigma) = log2(k) by bisection."""
    target = np.log2(k)
    rho = np.zeros(knn_dists.shape[0])
    nonzero_mask = knn_dists > 0.0
    has_nz = nonzero_mask.any(axis=1)
    first_nz = np.where(nonzero_mask, knn_dists, np.inf).min(axis=1)
    rho[has_nz] = first_nz[has_nz]

    lo = np.zeros(knn_dists.shape[0])
    hi = np.full(knn_dists.shape[0], np.inf)
    mid = np.ones(knn_dists.shape[0])
    d = np.maximum(knn_dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-d / mid[:, None]).sum(axis=1)
        err = psum - target
        if np.all(np.abs(err) < SMOOTH_K_TOLERANCE):
            break
        too_big = err > 0
        hi = np.where(too_big, mid, hi)
        lo = np.where(too_big, lo, mid)
        mid = np.where(too_big, (lo + hi) / 2.0,
                       np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0))
    sigma = mid
    # umap's floor: sigma >= MIN_K_DIST_SCALE * mean distance
    mean_d = knn_dists.mean(axis=1)
    floor = np.where(rho > 0.0, MIN_K_DIST_SCALE * mean_d,
                     MIN_K_DIST_SCALE * knn_dists.mean())
    return rho, np.maximum(sigma, floor)


def fuzzy_simplicial_set(dist: np.ndarray, n_neighbors: int):
    """Symmetrised fuzzy graph as (rows, cols, vals) over the k-NN edges."""
    n = dist.shape[0]
    k = min(n_neighbors, n)
    knn_idx = np.argsort(dist, axis=1, kind="stable")[:, :k]  # self first
    knn_d = np.take_along_axis(dist, knn_idx, axis=1)
    rho, sigma = smooth_knn_dist(knn_d, k)

    w = np.exp(-np.maximum(knn_d - rho[:, None], 0.0) / sigma[:, None])
    w[:, 0] = 0.0  # no self loops (first neighbour is self at distance 0)

    from scipy.sparse import coo_matrix

    rows = np.repeat(np.arange(n), k)
    mat = coo_matrix((w.ravel(), (rows, knn_idx.ravel())), shape=(n, n)).tocsr()
    mat.eliminate_zeros()
    t = mat.T.tocsr()
    sym = mat + t - mat.multiply(t)  # probabilistic t-conorm
    sym = sym.tocoo()
    keep = sym.data > 0.0
    return sym.row[keep], sym.col[keep], sym.data[keep]


def spectral_init(rows, cols, vals, n, n_components, seed=42):
    """Bottom nontrivial eigenvectors of the sym-normalised Laplacian,
    scaled to [-10, 10] with a small jitter (umap's 'spectral' init)."""
    from scipy.sparse import coo_matrix, identity

    rng = np.random.default_rng(seed)
    w = coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    deg = np.asarray(w.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = identity(n) - w.multiply(dinv[:, None]).multiply(dinv[None, :])

    k = n_components + 1
    try:
        if n <= 4096:
            from scipy.linalg import eigh

            _, vecs = eigh(lap.toarray(), subset_by_index=[0, k - 1])
        else:
            from scipy.sparse.linalg import eigsh

            _, vecs = eigsh(lap.tocsc(), k=k, which="SM", tol=1e-4,
                            maxiter=n * 5)
        emb = vecs[:, 1:k]
    except Exception:
        emb = rng.normal(0.0, 1.0, (n, n_components))
    expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
    emb = emb * expansion + rng.normal(0.0, 1e-4, (n, n_components))
    return emb.astype(np.float32)


def optimize_layout(y0, heads, tails, probs, a: float, b: float,
                    n_epochs: int, neg_rate: int, gen: torch.Generator):
    """``n_epochs`` epochs of the layout on ``y0``'s device; returns the
    layout [N, D]. ``heads``/``tails``: [E] edge endpoints, ``probs``: [E]
    per-epoch sampling probabilities."""
    y = y0.clone()
    n, dev = y.shape[0], y.device
    n_edges = heads.shape[0]
    for i in range(n_epochs):
        alpha = 1.0 - i / n_epochs
        mask = (torch.rand(n_edges, generator=gen, device=dev)
                < probs).to(y.dtype)[:, None]

        diff = y[heads] - y[tails]
        d2 = (diff * diff).sum(dim=1, keepdim=True).clamp_min(1e-12)
        # attraction: -2ab d^(2(b-1)) / (1 + a d^(2b))
        att = -2.0 * a * b * d2.pow(b - 1.0) / (1.0 + a * d2.pow(b))
        g_att = (att * diff).clamp(-4.0, 4.0) * mask
        y.index_add_(0, heads, alpha * g_att)
        y.index_add_(0, tails, -alpha * g_att)

        # repulsion: neg_rate uniform negatives per sampled edge, the head
        # moves; each negative is read after the previous one's update
        neg = torch.randint(0, n, (n_edges, neg_rate), generator=gen,
                            device=dev)
        yh = y[heads]
        for j in range(neg_rate):
            diff_n = yh - y[neg[:, j]]
            d2n = (diff_n * diff_n).sum(dim=1, keepdim=True)
            rep = 2.0 * b / ((0.001 + d2n)
                             * (1.0 + a * d2n.clamp_min(1e-12).pow(b)))
            g_rep = torch.where(d2n > 0.0, (rep * diff_n).clamp(-4.0, 4.0),
                                torch.full_like(diff_n, 4.0)) * mask
            y.index_add_(0, heads, alpha * g_rep)
    return y


def umap_embed(x: np.ndarray, n_neighbors: int = 15, n_components: int = 2,
               min_dist: float = 0.1, spread: float = 1.0,
               metric: str = "euclidean", n_epochs: int | None = None,
               negative_sample_rate: int = 5, seed: int = 42,
               device=DEFAULT_DEVICE) -> np.ndarray:
    """fit_transform-equivalent embedding [N, n_components]; the layout is
    optimised on ``device``."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        return np.empty((0, n_components), dtype=np.float32)
    if n <= n_components + 1:
        rng = np.random.default_rng(seed)
        return rng.normal(0.0, 1.0, (n, n_components)).astype(np.float32)

    if metric == "euclidean":
        dist = pairwise_euclidean(x)
    elif metric == "cosine":
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        dist = np.clip(1.0 - xn @ xn.T, 0.0, None)
        np.fill_diagonal(dist, 0.0)
    else:
        raise ValueError(f"unsupported metric {metric!r}")

    rows, cols, vals = fuzzy_simplicial_set(dist, n_neighbors)
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    # umap drops edges too weak to be sampled even once
    keep = vals >= vals.max() / float(n_epochs)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    y0 = spectral_init(rows, cols, vals, n, n_components, seed)
    a, b = find_ab_params(spread, min_dist)

    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        y = optimize_layout(
            torch.as_tensor(y0, device=dev),
            torch.as_tensor(rows, dtype=torch.long, device=dev),
            torch.as_tensor(cols, dtype=torch.long, device=dev),
            torch.as_tensor((vals / vals.max()).astype(np.float32), device=dev),
            float(a), float(b), int(n_epochs), int(negative_sample_rate), gen)
    return y.cpu().numpy().astype(np.float32)
