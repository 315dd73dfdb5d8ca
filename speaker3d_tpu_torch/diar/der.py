"""Diarization error rate, interval-exact, native Python.

This package's own copy of ``speaker3d_tpu/diar/der.py`` (pure numpy and
scipy, the same numbers).

Behavioral contract: NIST RT `md-eval.pl` semantics as wrapped by the
reference (reference: egs/3dspeaker/speaker-diarization/local/DER.py:87-154,
local/md-eval.pl): MISS/FA/speaker-error over the reference speech timeline,
a +/- collar "no-score" zone around every reference segment boundary, an
optional ignore-overlap mode, and a global optimal (Hungarian) speaker
mapping computed on scored overlap time.

DER = (MISS + FA + SPKERR) / total scored reference speaker time.

Implementation is an exact interval sweep-line (no frame quantization), which
matches md-eval's interval arithmetic.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple, Optional

import numpy as np

Segment = Tuple[float, float, str]  # (start, end, speaker)


def load_rttm(path) -> Dict[str, List[Segment]]:
    """Parse SPEAKER lines of an RTTM file -> {file_id: [(st, ed, spk)]}."""
    out: Dict[str, List[Segment]] = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            fid, st, dur, spk = parts[1], float(parts[3]), float(parts[4]), parts[7]
            out[fid].append((st, st + dur, spk))
    return dict(out)


def _events(ref: Sequence[Segment], hyp: Sequence[Segment],
            no_score: Sequence[Tuple[float, float]]):
    """Sweep-line boundaries across all segments and no-score zones."""
    pts = set()
    for st, ed, _ in list(ref) + list(hyp):
        pts.add(st)
        pts.add(ed)
    for st, ed in no_score:
        pts.add(st)
        pts.add(ed)
    return sorted(pts)


def _active(segs: Sequence[Segment], t0: float, t1: float) -> List[str]:
    """DISTINCT speakers active in (t0, t1) — a speaker with overlapping
    segments counts once (md-eval tracks per-speaker activity, not
    per-segment; double-counting inflated FA on same-speaker overlaps)."""
    mid0, mid1 = t0, t1
    return sorted({spk for st, ed, spk in segs if st < mid1 and ed > mid0})


def _no_score_zones(ref: Sequence[Segment], collar: float):
    """+/- collar zones around every reference boundary (md-eval -c)."""
    if collar <= 0:
        return []
    zones = []
    for st, ed, _ in ref:
        zones.append((st - collar, st + collar))
        zones.append((ed - collar, ed + collar))
    zones.sort()
    merged = []
    for z in zones:
        if merged and z[0] <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], z[1]))
        else:
            merged.append(z)
    return merged


def _subtract_zones(t0: float, t1: float, zones) -> List[Tuple[float, float]]:
    """Scored sub-intervals of [t0, t1] after removing no-score zones."""
    pieces = [(t0, t1)]
    for z0, z1 in zones:
        nxt = []
        for a, b in pieces:
            if z1 <= a or z0 >= b:
                nxt.append((a, b))
            else:
                if a < z0:
                    nxt.append((a, z0))
                if z1 < b:
                    nxt.append((z1, b))
        pieces = nxt
        if not pieces:
            break
    return pieces


class DERResult:
    def __init__(self, miss, fa, spkerr, total):
        self.miss = miss
        self.fa = fa
        self.spkerr = spkerr
        self.total = total

    @property
    def der(self) -> float:
        return ((self.miss + self.fa + self.spkerr) / self.total
                if self.total > 0 else 0.0)

    def __repr__(self):
        return (f"DER {100*self.der:.2f}% (MISS {100*self.miss/max(self.total,1e-9):.2f} "
                f"FA {100*self.fa/max(self.total,1e-9):.2f} "
                f"SER {100*self.spkerr/max(self.total,1e-9):.2f})")


def compute_der(ref: Sequence[Segment], hyp: Sequence[Segment],
                collar: float = 0.25, ignore_overlap: bool = False,
                uem: Optional[Sequence[float]] = None) -> DERResult:
    """DER for one file. ``collar`` is the +/- no-score width in seconds
    (md-eval -c 0.25 convention). ``uem``: (begin, end) evaluation region;
    by default md-eval derives it from the REFERENCE span
    (md-eval.pl:658 uem_from_rttm), so hypothesis speech before the first /
    after the last reference boundary is not scored as false alarm. Pass
    (-inf, inf) to score everything."""
    if uem is None:
        uem = ((min(s for s, _, _ in ref), max(e for _, e, _ in ref))
               if ref else (0.0, 0.0))
    hyp = [(max(s, uem[0]), min(e, uem[1]), spk) for s, e, spk in hyp
           if min(e, uem[1]) - max(s, uem[0]) > 0]
    ref = [(max(s, uem[0]), min(e, uem[1]), spk) for s, e, spk in ref
           if min(e, uem[1]) - max(s, uem[0]) > 0]
    zones = _no_score_zones(ref, collar)
    pts = _events(ref, hyp, zones)

    # Pass 1: overlap matrix between ref/hyp speakers over scored time.
    ref_spks = sorted({s for _, _, s in ref})
    hyp_spks = sorted({s for _, _, s in hyp})
    overlap = np.zeros((len(ref_spks), len(hyp_spks)))
    r_index = {s: i for i, s in enumerate(ref_spks)}
    h_index = {s: i for i, s in enumerate(hyp_spks)}

    intervals = []
    for t0, t1 in zip(pts[:-1], pts[1:]):
        if t1 <= t0:
            continue
        for a, b in _subtract_zones(t0, t1, zones):
            if b <= a:
                continue
            r_act = _active(ref, a, b)
            h_act = _active(hyp, a, b)
            if ignore_overlap and len(r_act) > 1:
                continue
            intervals.append((a, b, r_act, h_act))
            d = b - a
            for rs in set(r_act):
                for hs in set(h_act):
                    overlap[r_index[rs], h_index[hs]] += d

    # Global optimal speaker mapping (md-eval uses optimum one-to-one map).
    mapping = {}
    if overlap.size:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-overlap)
        for r, c in zip(rows, cols):
            if overlap[r, c] > 0:
                mapping[ref_spks[r]] = hyp_spks[c]

    miss = fa = spkerr = total = 0.0
    for a, b, r_act, h_act in intervals:
        d = b - a
        nref, nhyp = len(r_act), len(h_act)
        total += d * nref
        nmatched = sum(1 for rs in set(r_act)
                       if mapping.get(rs) in set(h_act))
        miss += d * max(0, nref - nhyp)
        fa += d * max(0, nhyp - nref)
        spkerr += d * (min(nref, nhyp) - min(nmatched, min(nref, nhyp)))
    return DERResult(miss, fa, spkerr, total)


def compute_der_for_files(ref_by_file: Dict[str, List[Segment]],
                          hyp_by_file: Dict[str, List[Segment]],
                          collar: float = 0.25,
                          ignore_overlap: bool = False) -> DERResult:
    """Corpus-level DER: error times summed across files (md-eval behavior)."""
    miss = fa = spkerr = total = 0.0
    for fid, ref in ref_by_file.items():
        hyp = hyp_by_file.get(fid, [])
        r = compute_der(ref, hyp, collar, ignore_overlap)
        miss += r.miss
        fa += r.fa
        spkerr += r.spkerr
        total += r.total
    return DERResult(miss, fa, spkerr, total)
