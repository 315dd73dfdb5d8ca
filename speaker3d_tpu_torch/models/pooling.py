"""Temporal statistics pooling over a 2D trunk's NCHW output [B, C, F, T].

The flatten order is the reference's (C, F), so the projection weights line
up with reference checkpoints. The variance is unbiased (ddof=1), as
``torch.var``'s default in the reference.
"""

from __future__ import annotations

import torch


def tstp(x):
    """Temporal statistics pooling, mean ‖ std: [B, C, F, T] -> [B, 2*C*F]."""
    mean = x.mean(dim=-1).flatten(1)
    std = torch.sqrt(x.var(dim=-1, unbiased=True) + 1e-8).flatten(1)
    return torch.cat([mean, std], dim=1)
