"""Native HDBSCAN* — no external `hdbscan` dependency.

This package's own copy of ``speaker3d_tpu/diar/hdbscan_native.py`` (pure
numpy and scipy, same labels bit for bit).

Implements the full algorithm from Campello/Moulavi/Sander 2013 as used by
the reference's UmapHdbscan backend (reference: speakerlab/process/
cluster.py:115-137, `hdbscan.HDBSCAN(min_samples, min_cluster_size)
.fit_predict`):

  1. core distances from the k-NN graph (k = min_samples, self included —
     scikit-learn/hdbscan-library semantics),
  2. mutual-reachability distance  mr(i,j) = max(core_i, core_j, d(i,j)),
  3. minimum spanning tree of the mutual-reachability graph,
  4. single-linkage hierarchy from sorted MST edges (union-find),
  5. condensed tree at `min_cluster_size` (points fall out of a cluster at
     lambda = 1/distance when their sub-branch is too small to survive),
  6. per-cluster stability  sum((lambda_leave - lambda_birth) * size),
  7. excess-of-mass cluster selection (root never selected, matching
     `allow_single_cluster=False`),
  8. labelling: points under a selected cluster get its id, others -1.

Diarization feeds N ~ 1e3-1e4 chunk embeddings, so the dense O(N^2)
mutual-reachability matrix is a single matmul + elementwise max and the MST
comes from `scipy.sparse.csgraph` — no approximate NN structures needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def pairwise_euclidean(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.maximum(d2, 0.0, out=d2)
    np.fill_diagonal(d2, 0.0)
    return np.sqrt(d2)


def mutual_reachability(dist: np.ndarray, min_samples: int) -> np.ndarray:
    """max(core_i, core_j, d_ij); core = distance to the min_samples-th
    nearest neighbour with the point itself counted as neighbour 0."""
    n = dist.shape[0]
    k = min(min_samples, n) - 1  # self excluded from the sort offset
    core = np.partition(dist, k, axis=1)[:, k]
    mr = np.maximum(dist, core[:, None])
    np.maximum(mr, core[None, :], out=mr)
    np.fill_diagonal(mr, 0.0)
    return mr


def _mst_edges(mr: np.ndarray) -> np.ndarray:
    """MST edges [u, v, w] sorted by weight ascending."""
    from scipy.sparse.csgraph import minimum_spanning_tree

    n = mr.shape[0]
    # csgraph treats 0 as "no edge"; nudge exact-zero off-diagonal weights.
    g = np.where(mr <= 0.0, 1e-300, mr)
    np.fill_diagonal(g, 0.0)
    t = minimum_spanning_tree(g).tocoo()
    w = np.where(t.data <= 1e-300, 0.0, t.data)
    edges = np.stack([t.row.astype(np.float64), t.col.astype(np.float64), w],
                     axis=1)
    return edges[np.argsort(edges[:, 2], kind="stable")]


def single_linkage_tree(mr: np.ndarray) -> np.ndarray:
    """scipy-style linkage rows [id_a, id_b, dist, size] from the MST."""
    edges = _mst_edges(mr)
    n = mr.shape[0]
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:  # path compression
            parent[i], i = root, parent[i]
        return root

    rows = np.empty((len(edges), 4))
    nxt = n
    for t, (u, v, w) in enumerate(edges):
        ra, rb = find(int(u)), find(int(v))
        rows[t] = (ra, rb, w, size[ra] + size[rb])
        parent[ra] = parent[rb] = nxt
        size[nxt] = size[ra] + size[rb]
        nxt += 1
    return rows


@dataclass
class CondensedTree:
    parent: np.ndarray  # condensed cluster ids (>= n_points)
    child: np.ndarray   # point id (< n_points) or condensed cluster id
    lamb: np.ndarray    # lambda at which child leaves/appears
    size: np.ndarray
    n_points: int


def condense_tree(linkage: np.ndarray, min_cluster_size: int) -> CondensedTree:
    n = linkage.shape[0] + 1
    root = 2 * n - 2

    children = {}  # node id -> (left, right, dist)
    for t in range(linkage.shape[0]):
        children[n + t] = (int(linkage[t, 0]), int(linkage[t, 1]),
                           float(linkage[t, 2]))

    def subtree_points(node):
        out, stack = [], [node]
        while stack:
            cur = stack.pop()
            if cur < n:
                out.append(cur)
            else:
                left, right, _ = children[cur]
                stack.extend((left, right))
        return out

    def node_size(node):
        return 1 if node < n else int(linkage[node - n, 3])

    relabel = {root: n}
    next_label = n + 1
    rows = []
    stack = [root]
    while stack:  # pre-order; order within the list is irrelevant downstream
        node = stack.pop()
        if node < n:
            continue
        left, right, dist = children[node]
        lamb = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = node_size(left), node_size(right)
        label = relabel[node]

        if lc >= min_cluster_size and rc >= min_cluster_size:
            for ch in (left, right):
                relabel[ch] = next_label
                rows.append((label, next_label, lamb, node_size(ch)))
                next_label += 1
                stack.append(ch)
        elif lc < min_cluster_size and rc < min_cluster_size:
            for ch in (left, right):
                for p in subtree_points(ch):
                    rows.append((label, p, lamb, 1))
        else:
            keep, drop = (left, right) if lc >= min_cluster_size else (right, left)
            relabel[keep] = label
            stack.append(keep)
            for p in subtree_points(drop):
                rows.append((label, p, lamb, 1))

    arr = np.asarray(rows, dtype=np.float64).reshape(-1, 4)
    return CondensedTree(parent=arr[:, 0].astype(np.int64),
                         child=arr[:, 1].astype(np.int64),
                         lamb=arr[:, 2], size=arr[:, 3].astype(np.int64),
                         n_points=n)


def compute_stability(tree: CondensedTree) -> dict:
    births = {}  # cluster id -> lambda at which it appears
    for p, c, l in zip(tree.parent, tree.child, tree.lamb):
        if c >= tree.n_points:
            births[int(c)] = float(l)
    births[int(tree.parent.min())] = 0.0  # root

    stability = {}
    for p, l, s in zip(tree.parent, tree.lamb, tree.size):
        p = int(p)
        lamb = min(float(l), 1e300)  # inf-lambda leaves contribute hugely but finitely
        stability[p] = stability.get(p, 0.0) + (lamb - births[p]) * int(s)
    return stability


def select_clusters_eom(tree: CondensedTree, stability: dict) -> set:
    """Excess-of-mass selection; root excluded (allow_single_cluster=False)."""
    root = int(tree.parent.min())
    cluster_children = {}
    for p, c in zip(tree.parent, tree.child):
        if c >= tree.n_points:
            cluster_children.setdefault(int(p), []).append(int(c))

    is_cluster = {c: True for c in stability if c != root}
    # leaves-first: larger condensed labels are always deeper
    for node in sorted(is_cluster, reverse=True):
        sub = sum(stability[ch] for ch in cluster_children.get(node, []))
        if cluster_children.get(node) and sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            # deselect every descendant cluster
            stack = list(cluster_children.get(node, []))
            while stack:
                ch = stack.pop()
                is_cluster[ch] = False
                stack.extend(cluster_children.get(ch, []))
    return {c for c, flag in is_cluster.items() if flag}


def label_points(tree: CondensedTree, selected: set) -> np.ndarray:
    labels = np.full(tree.n_points, -1, dtype=np.int64)
    if not selected:
        return labels
    order = {c: i for i, c in enumerate(sorted(selected))}

    # map every condensed cluster to its nearest selected ancestor (or -1)
    parent_of = {int(c): int(p) for p, c in zip(tree.parent, tree.child)
                 if c >= tree.n_points}
    cache = {}

    def owner(cluster):
        seen = []
        cur = cluster
        while cur is not None and cur not in cache:
            if cur in selected:
                cache[cur] = order[cur]
                break
            seen.append(cur)
            cur = parent_of.get(cur)
        res = cache.get(cur, -1) if cur is not None else -1
        for s in seen:
            cache[s] = res
        return cache.setdefault(cluster, res)

    pts = tree.child < tree.n_points
    for p, c in zip(tree.parent[pts], tree.child[pts]):
        labels[int(c)] = owner(int(p))
    return labels


def hdbscan_labels(x: np.ndarray, min_samples: int = 5,
                   min_cluster_size: int = 5,
                   metric: str = "euclidean",
                   precomputed_dist: np.ndarray | None = None) -> np.ndarray:
    """fit_predict-equivalent: labels in {-1, 0, 1, ...}."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n <= min_cluster_size:
        return np.full(n, -1, dtype=np.int64)
    if precomputed_dist is not None:
        dist = np.asarray(precomputed_dist, dtype=np.float64)
    elif metric == "euclidean":
        dist = pairwise_euclidean(x)
    else:
        raise ValueError(f"unsupported metric {metric!r}")
    mr = mutual_reachability(dist, min_samples)
    linkage = single_linkage_tree(mr)
    tree = condense_tree(linkage, max(2, min_cluster_size))
    stability = compute_stability(tree)
    selected = select_clusters_eom(tree, stability)
    return label_points(tree, selected)
