"""Sequential-speaker boundary detection from chunk embeddings (host numpy).

The counterpart of ``speaker3d_tpu/diar/boundaries.py``, with the same
arguments and results; the GMMs are ``diar/gmm.py``'s (scikit-learn's
``GaussianMixture`` in the JAX package, which the card's machine lacks).

Behavioral contract (reference: egs/split_sequential_speakers/
detect_boundaries_from_embeddings.py — the fork's tool for splitting
recordings where N speakers talk strictly in sequence): given per-chunk
embeddings and theoretical (equal-split) boundaries, refine each boundary
within a window by maximizing either
  - cosine score: mean cosine of left chunk to the left-segment center plus
    mean cosine of right chunks to the right-segment center
    (find_precise_boundary:272), or
  - GMM separation: (log-prob of each side under its own GMM) minus
    (log-prob under the other side's GMM) (find_precise_boundary_gmm:344),
with per-boundary validation accuracy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from speaker3d_tpu_torch.diar.cluster import l2_normalize as _l2
from speaker3d_tpu_torch.diar.gmm import GaussianMixture


def calculate_segment_centers(embeddings: np.ndarray,
                              boundaries: List[int]) -> List[np.ndarray]:
    """Mean embedding per segment delimited by boundaries."""
    edges = [0] + list(boundaries) + [len(embeddings)]
    return [embeddings[a:b].mean(axis=0) for a, b in zip(edges[:-1], edges[1:])
            if b > a]


def train_speaker_gmm(embeddings: np.ndarray, n_components: int = 2,
                      min_samples: int = 10):
    """(reference: detect_boundaries_from_embeddings.py:180-215) None
    where the fit fails or does not converge."""
    if len(embeddings) < min_samples:
        return None
    n_components = min(n_components, max(1, len(embeddings) // 5))
    gmm = GaussianMixture(n_components=n_components, max_iter=100,
                          random_state=0)
    try:
        gmm.fit(embeddings)
    except Exception:
        return None
    return gmm if gmm.converged_ else None


def find_precise_boundary(embeddings: np.ndarray, theoretical: int,
                          left_center: np.ndarray, right_center: np.ndarray,
                          boundary_window: int = 10) -> Tuple[int, Dict]:
    """Cosine-center refinement. (reference: :272-343)"""
    n = len(embeddings)
    start = max(0, theoretical - boundary_window)
    end = min(n, theoretical + boundary_window + 1)
    emb_n = _l2(embeddings)
    lc, rc = _l2(left_center[None])[0], _l2(right_center[None])[0]
    best, best_score = theoretical, -np.inf
    for cand in range(max(start, 1), min(end, n)):
        score = float(np.mean(emb_n[:cand] @ lc) + np.mean(emb_n[cand:] @ rc))
        if score > best_score:
            best, best_score = cand, score
    left_sims = emb_n[:best] @ lc
    right_sims = emb_n[best:] @ rc
    total = len(left_sims) + len(right_sims)
    validation = {
        "overall_accuracy": float((np.sum(left_sims > 0.5)
                                   + np.sum(right_sims > 0.5)) / max(total, 1)),
        "left_avg_similarity": float(np.mean(left_sims)) if len(left_sims) else 0.0,
        "right_avg_similarity": float(np.mean(right_sims)) if len(right_sims) else 0.0,
        "boundary_score": float(best_score),
    }
    return best, {"theoretical_boundary": theoretical, "validation": validation}


def gmm_separation_score(embeddings: np.ndarray, boundary: int, left_gmm,
                         right_gmm, window: int = 20) -> float:
    """(reference: :230-270) correct-assignment minus wrong-assignment
    log-likelihoods around the boundary."""
    a = max(0, boundary - window)
    b = min(len(embeddings), boundary + window)
    left, right = embeddings[a:boundary], embeddings[boundary:b]
    if len(left) == 0 or len(right) == 0:
        return -np.inf

    def lp(g, x):
        return float(np.mean(g.score_samples(x))) if g is not None else 0.0

    correct = lp(left_gmm, left) + lp(right_gmm, right)
    wrong = lp(right_gmm, left) + lp(left_gmm, right)
    return correct - wrong


def find_precise_boundary_gmm(embeddings: np.ndarray, theoretical: int,
                              boundary_window: int = 10,
                              gmm_window: int = 50) -> Tuple[int, Dict]:
    """GMM refinement. (reference: :344-396)"""
    n = len(embeddings)
    left_gmm = train_speaker_gmm(
        embeddings[max(0, theoretical - gmm_window):theoretical])
    right_gmm = train_speaker_gmm(
        embeddings[theoretical:min(n, theoretical + gmm_window)])
    if left_gmm is None or right_gmm is None:
        centers = calculate_segment_centers(embeddings, [theoretical])
        if len(centers) < 2:
            return theoretical, {"method": "fallback"}
        return find_precise_boundary(embeddings, theoretical, centers[0],
                                     centers[1], boundary_window)
    best, best_score = theoretical, -np.inf
    for cand in range(max(1, theoretical - boundary_window),
                      min(n, theoretical + boundary_window + 1)):
        s = gmm_separation_score(embeddings, cand, left_gmm, right_gmm)
        if s > best_score:
            best, best_score = cand, s
    return best, {"method": "gmm", "separation_score": float(best_score)}


def detect_speaker_boundaries(embeddings: np.ndarray, num_speakers: int,
                              method: str = "cosine",
                              boundary_window: int = 10) -> List[int]:
    """Split N sequential speakers: equal theoretical boundaries, each
    refined locally. (reference: detect_speaker_boundaries:561)"""
    n = len(embeddings)
    if num_speakers <= 1 or n < 2 * num_speakers:
        return []
    theoretical = [round(i * n / num_speakers) for i in range(1, num_speakers)]
    out = []
    for tb in theoretical:
        if method == "gmm":
            b, _ = find_precise_boundary_gmm(embeddings, tb,
                                             boundary_window=boundary_window)
        else:
            centers = calculate_segment_centers(embeddings, [tb])
            b, _ = find_precise_boundary(embeddings, tb, centers[0],
                                         centers[1],
                                         boundary_window=boundary_window)
        out.append(int(b))
    return sorted(out)
