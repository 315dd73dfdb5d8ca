"""Paraformer-style low-frame-rate (LFR) stacking on batched features.

The counterpart of ``apply_lfr_device`` in
``speaker3d_tpu/data/processor_para.py``: window ``lfr_m`` frames at hop
``lfr_n``, left-padded by repeating the first frame ``(lfr_m - 1) // 2``
times and tail-padded by repeating the last frame, the ``lfr_m`` taps
concatenated on the feature axis. The host variants (``apply_lfr``,
``apply_cmvn``, ``load_cmvn``) come with ``train_para`` (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch


def apply_lfr_device(x: torch.Tensor, lfr_m: int, lfr_n: int) -> torch.Tensor:
    """[B, T, D] -> [B, ceil(T / lfr_n), lfr_m * D], from strided slices
    (no gather), on ``x``'s device."""
    b, t, d = x.shape
    t_lfr = -(-t // lfr_n)
    left = (lfr_m - 1) // 2
    x = torch.cat([x[:, :1].expand(b, left, d), x], dim=1)
    need = (t_lfr - 1) * lfr_n + lfr_m
    if need > x.shape[1]:
        x = torch.cat([x, x[:, -1:].expand(b, need - x.shape[1], d)], dim=1)
    span = (t_lfr - 1) * lfr_n + 1
    return torch.cat([x[:, i:i + span:lfr_n] for i in range(lfr_m)], dim=-1)
