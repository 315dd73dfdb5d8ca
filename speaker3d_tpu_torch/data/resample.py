"""Segment-targeted polyphase resampling for speed perturbation.

The counterpart of ``speaker3d_tpu/data/resample.py`` in numpy/scipy (no
native library). ``resample_poly_segment(x, up, down, o0, n_out)`` is
``scipy.signal.resample_poly(x, up, down)[o0:o0 + n_out]``: the filter is
scipy's own design (``firwin``, Kaiser window, beta 5), and only the crop's
receptive field is filtered, each output a float32 dot product of one
polyphase branch with its input window, accumulated tap by tap in order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def _design(up: int, down: int):
    """scipy resample_poly's filter for (up, down) as a per-phase bank
    [up, taps] (each branch reversed, so tap k meets the k-th sample of an
    ascending window), and the output offset of the filter's delay."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)).astype(np.float32)
    h = h * np.float32(up)
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h_pad = np.concatenate([np.zeros(n_pre_pad, np.float32), h])
    taps = -(-len(h_pad) // up)
    bank = np.zeros((up, taps), np.float32)
    for p in range(up):
        branch = h_pad[p::up]
        bank[p, taps - len(branch):] = branch[::-1]
    return bank, n_pre_remove


def out_len(n_in: int, up: int, down: int) -> int:
    """Output length of resample_poly(x, up, down) for len(x) == n_in."""
    return -(-n_in * up // down)


def resample_poly_segment(x: np.ndarray, up: int, down: int, o0: int,
                          n_out: int) -> np.ndarray:
    """== scipy.signal.resample_poly(x, up, down)[o0:o0+n_out] (float32)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D signal, got shape {x.shape}")
    total = out_len(len(x), up, down)
    if not (0 <= o0 and o0 + n_out <= total):
        raise ValueError(f"segment [{o0}, {o0+n_out}) outside [0, {total})")
    bank, npr = _design(up, down)
    taps = bank.shape[1]
    t = (o0 + np.arange(n_out, dtype=np.int64) + npr) * down
    i_hi = t // up
    phase = t - i_hi * up
    # input window of output m: x[i_hi - taps + 1 .. i_hi], zero outside x
    lo = int(i_hi[0]) - taps + 1 if n_out else 0
    hi = int(i_hi[-1]) + 1 if n_out else 0
    xp = np.zeros(hi - lo, np.float32)
    a, b = max(lo, 0), min(hi, len(x))
    if b > a:
        xp[a - lo:b - lo] = x[a:b]
    start = i_hi - taps + 1 - lo
    coeff = bank[phase]                                  # [n_out, taps]
    acc = np.zeros(n_out, np.float32)
    for k in range(taps):
        acc += coeff[:, k] * xp[start + k]
    return acc


def speed_ratio(speed: float):
    """sox `speed S` == resample by 1/S: (up, down) in lowest terms."""
    ratio = {0.9: (10, 9), 1.1: (10, 11)}.get(speed)
    if ratio is None:
        from fractions import Fraction

        fr = Fraction(1.0 / speed).limit_denominator(100)
        ratio = (fr.numerator, fr.denominator)
    return ratio
