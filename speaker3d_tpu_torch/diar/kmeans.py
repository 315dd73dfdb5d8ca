"""k-means on the host, without scikit-learn.

The JAX package's spectral clustering calls ``sklearn.cluster.k_means(emb,
k, n_init=10, random_state=...)``; the card's machine has no scikit-learn,
so this module computes the same thing: greedy k-means++ seeding
(2 + int(log k) candidates per centre), Lloyd iterations to strict
convergence or a total squared centre shift within ``tol`` times the mean
feature variance, ten starts, the lowest inertia kept.

``random_state``: None draws from numpy's global RNG (as scikit-learn does,
so repeated calls differ unless the caller seeds it); an int seeds a
private ``np.random.RandomState``; a ``RandomState`` is used as is. Label
numbers cannot match scikit-learn's draw for draw; partitions and inertia
do on separated data.
"""

from __future__ import annotations

import numpy as np


def _random_state(random_state) -> np.random.RandomState:
    if random_state is None:
        return np.random.mtrand._rand
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _sq_dists(x, centers):
    d2 = ((x * x).sum(1)[:, None] - 2.0 * (x @ centers.T)
          + (centers * centers).sum(1)[None, :])
    return np.maximum(d2, 0.0)


def kmeans_plusplus(x: np.ndarray, k: int, rng) -> np.ndarray:
    """Greedy k-means++: each new centre is the best of 2 + int(log k)
    candidates drawn in proportion to the squared distance to the nearest
    centre so far."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]))
    centers[0] = x[rng.randint(n)]
    closest = _sq_dists(x, centers[:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        ids = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * pot)
        ids = np.clip(ids, None, n - 1)
        cand = np.minimum(closest[None, :], _sq_dists(x, x[ids]).T)
        best = int(np.argmin(cand.sum(1)))
        closest, pot = cand[best], cand[best].sum()
        centers[c] = x[ids[best]]
    return centers


def _lloyd(x, centers, max_iter, tol):
    labels = None
    strict = False
    for _ in range(max_iter):
        d2 = _sq_dists(x, centers)
        new_labels = d2.argmin(1)
        new = np.zeros_like(centers)
        np.add.at(new, new_labels, x)
        counts = np.bincount(new_labels, minlength=len(centers))
        empty = np.flatnonzero(counts == 0)
        if len(empty):
            # the points farthest from their centres start the empty ones
            far = np.argsort(-d2[np.arange(len(x)), new_labels],
                             kind="stable")[:len(empty)]
            for c, p in zip(empty, far):
                new[new_labels[p]] -= x[p]
                counts[new_labels[p]] -= 1
                new[c], counts[c] = x[p], 1
        new /= counts[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if labels is not None and np.array_equal(new_labels, labels):
            strict = True
            break
        labels = new_labels
        if shift <= tol:
            break
    d2 = _sq_dists(x, centers)
    if not strict:
        labels = d2.argmin(1)
    return labels, float(d2[np.arange(len(x)), labels].sum()), centers


def k_means(x: np.ndarray, k: int, n_init: int = 10, random_state=None,
            max_iter: int = 300, tol: float = 1e-4):
    """(labels [N], inertia) of the best of ``n_init`` k-means runs on
    ``x`` [N, D] (float64 on the host)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean(axis=0)
    rng = _random_state(random_state)
    tol = float(np.mean(np.var(x, axis=0))) * tol
    best = None
    for _ in range(n_init):
        labels, inertia, _ = _lloyd(x, kmeans_plusplus(x, k, rng), max_iter,
                                    tol)
        if best is None or inertia < best[1]:
            best = (labels, inertia)
    return best
