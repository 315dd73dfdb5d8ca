"""Speaker-verification metrics: EER, minDCF, accuracy, AP.

The port's own copy of ``speaker3d_tpu/utils/metrics.py`` (reference:
speakerlab/utils/score_metrics.py — NIST SRE metrics): robust FNR/FPR curves
via sorted cumulative weights, linear EER interpolation at the crossing,
normalized minimum detection cost.

Plain numpy on the host: trial counts are ~1e5-1e7 scalars. The cosine
scoring that feeds these metrics lives in ``eval/scoring.py``.
"""

from __future__ import annotations

import numpy as np


def fnr_fpr_curve(scores, labels, weights=None):
    """Robust FNR/FPR over all operating points (sorted-score sweep).

    Returns (fnr, fpr) arrays aligned with np.sort(scores).
    (reference: utils/score_metrics.py:57-75 compute_pmiss_pfa_rbst)
    """
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    order = np.argsort(scores, kind="stable")
    labels = labels[order]
    if weights is None:
        weights = np.ones_like(labels, dtype=np.float64)
    else:
        weights = np.asarray(weights, dtype=np.float64)[order]
    tgt = weights * (labels == 1)
    imp = weights * (labels == 0)
    fnr = np.cumsum(tgt) / max(np.sum(tgt), 1e-30)
    fpr = 1.0 - np.cumsum(imp) / max(np.sum(imp), 1e-30)
    return fnr, fpr


def compute_eer(scores=None, labels=None, *, fnr=None, fpr=None,
                return_threshold=False):
    """Equal error rate with linear interpolation at the DET crossing.
    (reference: utils/score_metrics.py:78-92)"""
    if fnr is None or fpr is None:
        fnr, fpr = fnr_fpr_curve(scores, labels)
    if return_threshold and scores is None:
        raise ValueError("return_threshold=True requires `scores` "
                         "(thresholds are score values)")
    diff = fnr - fpr
    pos, neg = np.flatnonzero(diff >= 0), np.flatnonzero(diff < 0)
    if len(pos) == 0 or len(neg) == 0:
        # degenerate curve (e.g. perfectly separated tiny trial lists):
        # no DET crossing exists — the reference formula would crash here
        # (utils/score_metrics.py:84-85); report the best achievable
        # balanced operating point instead (0 for perfect separation).
        eer = float(np.min(np.maximum(fnr, fpr)))
        if return_threshold:
            idx = int(np.argmin(np.maximum(fnr, fpr)))
            return eer, float(np.sort(np.asarray(scores))[idx])
        return eer
    x1 = pos[0]
    x2 = neg[-1]
    denom = fpr[x2] - fpr[x1] - (fnr[x2] - fnr[x1])
    a = (fnr[x1] - fpr[x1]) / denom if denom != 0 else 0.0
    eer = fnr[x1] + a * (fnr[x2] - fnr[x1])
    if return_threshold:
        thr = np.sort(np.asarray(scores))[x1]
        return float(eer), float(thr)
    return float(eer)


def compute_min_dcf(scores=None, labels=None, *, fnr=None, fpr=None,
                    p_target=0.01, c_miss=1.0, c_fa=1.0, normalize=True):
    """Minimum detection cost, optionally normalized by the default cost.
    (reference: utils/score_metrics.py:95-115)"""
    if fnr is None or fpr is None:
        fnr, fpr = fnr_fpr_curve(scores, labels)
    c_det = np.min(c_miss * fnr * p_target + c_fa * fpr * (1 - p_target))
    if not normalize:
        return float(c_det)
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    return float(c_det / c_def)


def det_curve_points(scores, labels):
    """(fnr, fpr) arrays for DET plotting."""
    return fnr_fpr_curve(scores, labels)


def plot_det_curve(fnr, fpr, save_path=None):
    """DET curve on probit axes. (reference: utils/score_metrics.py:118-159)"""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.stats import norm

    fnr = np.clip(np.asarray(fnr), 1e-6, 1 - 1e-6)
    fpr = np.clip(np.asarray(fpr), 1e-6, 1 - 1e-6)
    p_miss = norm.ppf(fnr)
    p_fa = norm.ppf(fpr)
    ticks = [1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.02, 0.05, 0.1,
             0.2, 0.4]
    labels = [str(t * 100) for t in ticks]
    plt.figure()
    plt.plot(p_fa, p_miss, "r")
    plt.xticks(norm.ppf(ticks), labels)
    plt.yticks(norm.ppf(ticks), labels)
    plt.xlim(norm.ppf([0.00051, 0.5]))
    plt.ylim(norm.ppf([0.00051, 0.5]))
    plt.xlabel("false-alarm rate [%]")
    plt.ylabel("false-reject rate [%]")
    eer = compute_eer(fnr=fnr, fpr=fpr)
    plt.plot(norm.ppf(eer), norm.ppf(eer), "o")
    plt.title(f"DET (EER = {100 * eer:.2f}%)")
    plt.grid(True)
    if save_path:
        plt.savefig(save_path)
        plt.close()
    return eer


def accuracy(logits, targets, topk=(1,)):
    """Top-k accuracy in percent. (reference: utils/utils.py accuracy)"""
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    return [float(correct[:, :k].any(axis=1).mean() * 100.0) for k in topk]


def average_precision(labels, scores):
    """AP over ranked scores. (reference: utils/utils.py average_precision)"""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    cum_pos = np.cumsum(labels)
    precision = cum_pos / np.arange(1, len(labels) + 1)
    n_pos = labels.sum()
    if n_pos == 0:
        return 0.0
    return float((precision * labels).sum() / n_pos)
