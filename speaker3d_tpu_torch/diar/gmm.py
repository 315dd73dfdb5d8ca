"""A diagonal Gaussian mixture on the host, without scikit-learn.

The JAX package's boundary refinement (``speaker3d_tpu/diar/boundaries.py``)
fits ``sklearn.mixture.GaussianMixture(n_components, covariance_type="diag",
max_iter=100, random_state=0)``; the card's machine has no scikit-learn, so
this module computes what that estimator computes with its defaults:

- ``init_params="kmeans"``: one k-means run (``n_init=1``) seeded by
  ``RandomState(random_state)``, whose first centre is drawn as
  ``sklearn.cluster.KMeans`` draws it (``diar/kmeans.py``), gives one-hot
  responsibilities, then an M-step with the weights divided by N;
- EM until the mean log-likelihood (the lower bound) changes by less than
  ``tol = 1e-3``, at most ``max_iter`` iterations; ``converged_`` says
  whether it did;
- ``reg_covar = 1e-6`` added to every variance; a variance <= 0 raises
  ``ValueError`` as scikit-learn does;
- ``score_samples``: the per-sample log-likelihood, a logsumexp over the
  components written as scikit-learn's.

The arithmetic runs in the input's floating dtype, as scikit-learn keeps
float32 input in float32 (float64 otherwise). Component order may differ
from scikit-learn's where k-means ends in another labelling; the fitted
mixture and ``score_samples`` do not.
"""

from __future__ import annotations

import math

import numpy as np

from speaker3d_tpu_torch.diar.kmeans import _lloyd, kmeans_plusplus

TOL = 1e-3          # scikit-learn's defaults
REG_COVAR = 1e-6


def _as_float(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected [n_samples, n_features], got {x.shape}")
    if not np.all(np.isfinite(x)):
        raise ValueError("input contains NaN or infinity")
    return x


def logsumexp_rows(a: np.ndarray) -> np.ndarray:
    """logsumexp over axis 1, as scikit-learn's ``_logsumexp`` computes it:
    the maxima counted apart, ``log1p`` of the rest's sum."""
    a_max = np.max(a, axis=1, keepdims=True)
    at_max = a == a_max
    rest = np.array(a, copy=True)
    rest[at_max] = -np.inf
    m = np.sum(at_max.astype(a.dtype), axis=1, keepdims=True, dtype=a.dtype)
    shift = np.where(np.isfinite(a_max), a_max, 0)
    s = np.sum(np.exp(rest - shift), axis=1, keepdims=True, dtype=a.dtype)
    s = np.where(s == 0, s, s / m)
    return np.squeeze(np.log1p(s) + np.log(m) + a_max, axis=1)


class GaussianMixture:
    """Diagonal-covariance Gaussian mixture fitted by EM (see the module
    docstring). After ``fit``: ``weights_`` [K], ``means_`` [K, D],
    ``covariances_`` [K, D], ``precisions_cholesky_`` [K, D],
    ``converged_``."""

    def __init__(self, n_components: int = 1, *, max_iter: int = 100,
                 random_state: int = 0):
        self.n_components = n_components
        self.max_iter = max_iter
        self.random_state = random_state

    def _kmeans_labels(self, x: np.ndarray) -> np.ndarray:
        """``KMeans(n_components, n_init=1, random_state=RandomState(seed))``
        labels: centred data, k-means++ seeds, Lloyd to strict convergence
        or a total squared centre shift within 1e-4 of the mean variance."""
        rng = np.random.RandomState(self.random_state)
        xc = x.astype(np.float64) - x.astype(np.float64).mean(axis=0)
        tol = float(np.mean(np.var(xc, axis=0))) * 1e-4
        centers = kmeans_plusplus(xc, self.n_components, rng, first="choice")
        labels, _, _ = _lloyd(xc, centers, 300, tol)
        return labels

    def _estimate(self, x: np.ndarray, resp: np.ndarray):
        nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
        means = (resp.T @ x) / nk[:, None]
        avg_x2 = (resp.T @ (x * x)) / nk[:, None]
        covariances = avg_x2 - means ** 2 + REG_COVAR
        if np.any(covariances <= 0.0):
            raise ValueError("a component's variance is not positive: "
                             "reg_covar too small or degenerate data")
        return nk, means, covariances

    def _set(self, weights, means, covariances) -> None:
        self.weights_ = weights
        self.means_ = means
        self.covariances_ = covariances
        self.precisions_cholesky_ = 1.0 / np.sqrt(covariances)

    def _weighted_log_prob(self, x: np.ndarray) -> np.ndarray:
        prec_chol = self.precisions_cholesky_
        log_det = np.sum(np.log(prec_chol), axis=1)
        prec = prec_chol ** 2
        log_prob = (np.sum(self.means_ ** 2 * prec, axis=1)
                    - 2.0 * (x @ (self.means_ * prec).T)
                    + (x ** 2 @ prec.T))
        log_gauss = (-0.5 * (x.shape[1] * math.log(2 * math.pi) + log_prob)
                     + log_det)
        return log_gauss + np.log(self.weights_)

    def fit(self, x) -> "GaussianMixture":
        x = _as_float(x)
        n = x.shape[0]
        if n < 2:
            raise ValueError(f"need at least 2 samples, got {n}")
        if n < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got "
                             f"n_components = {self.n_components}, "
                             f"n_samples = {n}")
        resp = np.zeros((n, self.n_components), dtype=x.dtype)
        resp[np.arange(n), self._kmeans_labels(x)] = 1
        weights, means, covariances = self._estimate(x, resp)
        weights /= n
        self._set(weights, means, covariances)

        lower = -np.inf
        converged = False
        for _ in range(self.max_iter):
            prev = lower
            weighted = self._weighted_log_prob(x)
            norm = logsumexp_rows(weighted)
            with np.errstate(under="ignore"):
                log_resp = weighted - norm[:, None]
            weights, means, covariances = self._estimate(x, np.exp(log_resp))
            weights /= np.sum(weights)
            self._set(weights, means, covariances)
            lower = np.mean(norm)
            if abs(lower - prev) < TOL:
                converged = True
                break
        self.converged_ = converged
        return self

    def score_samples(self, x) -> np.ndarray:
        """Per-sample log-likelihood [N] under the fitted mixture."""
        return logsumexp_rows(self._weighted_log_prob(_as_float(x)))
