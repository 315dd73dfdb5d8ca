"""Memory-lean average-linkage AHC via the nearest-neighbor-chain algorithm.

The counterpart of ``speaker3d_tpu/diar/ahc_nnchain.py``. For cosine
distances, average linkage needs no pairwise matrix: with L2-normalised rows
z_i, the mean pairwise cosine between clusters A and B is
(S_A . S_B) / (|A| |B|) with S_A = sum_{i in A} z_i, so a cluster is a
(sum-vector, size) pair and a nearest-neighbour query is one matvec. The
NN-chain algorithm builds the same dendrogram as scipy for this reducible
linkage in ~2N queries.

  - ``linkage_labels``: host numpy, float64, the readable reference.
  - ``device_linkage_labels``: the cluster sums live on the card in float32
    and each step is one matvec + argmin there; the chain and the merge
    bookkeeping stay on the host, so every step waits for one small device
    read (the JAX version runs the whole loop on the device in one
    ``while_loop``; a persistent kernel is later work).

Cut semantics match AHCluster: flat clusters = dendrogram components whose
merge heights (in -cos space) are <= -fix_cos_thr.
"""

from __future__ import annotations

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _normalize(X, dtype):
    z = np.asarray(X, dtype=dtype)
    n = np.linalg.norm(z, axis=1, keepdims=True)
    return z / np.maximum(n, 1e-12)


def nn_chain_merges(X, dtype=np.float64):
    """Full average-linkage dendrogram over -cosine distances.

    Returns ``(parent_a, parent_b, height)`` arrays of length N-1; merged
    cluster k gets id N+k (scipy convention)."""
    z = _normalize(X, dtype)
    n = z.shape[0]
    if n < 2:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, dtype))
    m = 2 * n - 1
    S = np.zeros((m, z.shape[1]), dtype)
    S[:n] = z
    size = np.zeros(m, dtype)
    size[:n] = 1.0
    active = np.zeros(m, bool)
    active[:n] = True

    out_a = np.zeros(n - 1, np.int64)
    out_b = np.zeros(n - 1, np.int64)
    out_h = np.zeros(n - 1, dtype)

    chain = np.zeros(m, np.int64)
    chain_len = 0
    n_merged = 0
    next_id = n
    while n_merged < n - 1:
        if chain_len == 0:
            chain[0] = int(np.flatnonzero(active)[0])
            chain_len = 1
        x = chain[chain_len - 1]
        d = -(S[:next_id] @ S[x]) / (size[x] * size[:next_id])
        d[~active[:next_id]] = np.inf
        d[x] = np.inf
        # prefer the chain predecessor on ties (standard NN-chain rule:
        # guarantees termination on exactly-tied distances)
        y = chain[chain_len - 2] if chain_len >= 2 else -1
        best = int(np.argmin(d))
        if y >= 0 and d[y] <= d[best]:
            best = y
        if best == y:  # reciprocal nearest neighbours -> merge
            h = d[best]
            a, b = (x, best) if x < best else (best, x)
            S[next_id] = S[a] + S[b]
            size[next_id] = size[a] + size[b]
            active[a] = active[b] = False
            active[next_id] = True
            out_a[n_merged], out_b[n_merged], out_h[n_merged] = a, b, h
            next_id += 1
            n_merged += 1
            chain_len -= 2
        else:
            chain[chain_len] = best
            chain_len += 1
    return out_a, out_b, out_h


def labels_from_merges(n, out_a, out_b, out_h, cut_height):
    """Flat clusters: union the merges with height <= cut_height. Labels are
    numbered by first appearance (leaf order)."""
    parent = np.arange(2 * n - 1)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for k in range(len(out_a)):
        if out_h[k] <= cut_height:
            parent[find(out_a[k])] = parent[find(out_b[k])] = n + k
    roots = {}
    labels = np.empty(n, np.int64)
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = len(roots)
        labels[i] = roots[r]
    return labels


def linkage_labels(X, fix_cos_thr, dtype=np.float64):
    """Host NN-chain AHC labels at the AHCluster threshold semantics."""
    X = np.asarray(X)
    n = X.shape[0]
    if n < 2:
        return np.zeros(n, np.int64)
    a, b, h = nn_chain_merges(X, dtype)
    return labels_from_merges(n, a, b, h, -float(fix_cos_thr))


def device_merges(X, device=DEFAULT_DEVICE):
    """``nn_chain_merges`` with the cluster sums on ``device`` in float32:
    one matvec + argmin per chain step, one device read per step."""
    dev = resolve_device(device)
    z = torch.as_tensor(_normalize(X, np.float32), device=dev)
    n, d = z.shape
    m = 2 * n - 1
    S = torch.zeros((m, d), dtype=torch.float32, device=dev)
    S[:n] = z
    size = torch.zeros(m, dtype=torch.float32, device=dev)
    size[:n] = 1.0
    inactive = torch.ones(m, dtype=torch.bool, device=dev)
    inactive[:n] = False
    inf = torch.tensor(float("inf"), device=dev)
    host_size = np.zeros(m, np.float32)
    host_size[:n] = 1.0
    host_active = np.zeros(m, bool)
    host_active[:n] = True

    out_a = np.zeros(n - 1, np.int64)
    out_b = np.zeros(n - 1, np.int64)
    out_h = np.zeros(n - 1, np.float32)
    chain: list = []
    next_id = n
    for k in range(n - 1):
        while True:
            if not chain:
                chain.append(int(np.flatnonzero(host_active)[0]))
            x = chain[-1]
            dists = -(S[:next_id] @ S[x]) / (size[x] * size[:next_id])
            dists = torch.where(inactive[:next_id], inf, dists)
            dists[x] = inf
            prev = chain[-2] if len(chain) >= 2 else x
            best = torch.argmin(dists)
            # one read: argmin, its distance and the predecessor's
            b, d_best, d_prev = torch.stack(
                [best.to(torch.float32), dists[best], dists[prev]]).tolist()
            best = int(b)
            if len(chain) >= 2 and d_prev <= d_best:
                best, d_best = prev, d_prev
            if len(chain) >= 2 and best == prev:
                break
            chain.append(best)
        a, b = min(x, best), max(x, best)
        S[next_id] = S[a] + S[b]
        host_size[next_id] = host_size[a] + host_size[b]
        size[next_id] = float(host_size[next_id])
        inactive[a] = inactive[b] = True
        inactive[next_id] = False
        host_active[a] = host_active[b] = False
        host_active[next_id] = True
        out_a[k], out_b[k], out_h[k] = a, b, d_best
        next_id += 1
        del chain[-2:]
    return out_a, out_b, out_h


def device_linkage_labels(X, fix_cos_thr, device=DEFAULT_DEVICE):
    """NN-chain AHC labels with the dendrogram built on ``device``
    (float32)."""
    X = np.asarray(X)
    n = X.shape[0]
    if n < 2:
        return np.zeros(n, np.int64)
    a, b, h = device_merges(X, device)
    return labels_from_merges(n, a, b, h, -float(fix_cos_thr))
