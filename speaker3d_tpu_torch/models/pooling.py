"""Temporal pooling: TAP (mean), TSDP (std), TSTP (mean ‖ std), ASTP
(attentive statistics).

The counterpart of ``speaker3d_tpu/models/pooling.py`` (reference:
speakerlab/models/eres2net/pooling_layers.py), on the reference's layouts:
[B, C, T] for 1D trunks and [B, C, F, T] for 2D trunks, flattened in the
reference's (C, F) order so that projection weights line up with reference
checkpoints. The variance is unbiased (ddof=1), as ``torch.var``'s default
in the reference.
"""

from __future__ import annotations

import torch
from torch import nn


def _std(x):
    return torch.sqrt(x.var(dim=-1, unbiased=True) + 1e-8).flatten(1)


def tap(x):
    """Temporal average pooling: [B, C, T] -> [B, C], [B, C, F, T] ->
    [B, C*F]."""
    return x.mean(dim=-1).flatten(1)


def tsdp(x):
    """Temporal standard-deviation pooling."""
    return _std(x)


def tstp(x):
    """Temporal statistics pooling, mean ‖ std: [B, C, F, T] -> [B, 2*C*F]
    ([B, C, T] -> [B, 2*C])."""
    return torch.cat([tap(x), _std(x)], dim=1)


POOLING_FUNCS = {"TAP": tap, "TSDP": tsdp, "TSTP": tstp}


def pooling_output_mult(name: str) -> int:
    """Number of statistics concatenated by the pooling function."""
    return 1 if name in ("TAP", "TSDP") else 2


def get_pooling(name: str):
    """The function of ``POOLING_FUNCS`` named ``name``; raises
    ``ValueError`` naming the choices otherwise."""
    if name not in POOLING_FUNCS:
        raise ValueError(f"unknown pooling_func {name!r}; expected one of "
                         f"{sorted(POOLING_FUNCS)}")
    return POOLING_FUNCS[name]


class ASTP(nn.Module):
    """Attentive statistics pooling (ECAPA-style): a tanh bottleneck, a
    softmax over time, the attention-weighted mean ‖ std; optionally the
    global mean and std as context. ``linear1``/``linear2`` are k=1
    ``Conv1d``s, as in the reference. x: [B, C, T], or [B, C, F, T] merged
    to [B, C*F, T]. Output [B, 2*in_dim]."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128,
                 global_context_att: bool = False):
        super().__init__()
        self.global_context_att = global_context_att
        self.linear1 = nn.Conv1d(in_dim * (3 if global_context_att else 1),
                                 bottleneck_dim, kernel_size=1)
        self.linear2 = nn.Conv1d(bottleneck_dim, in_dim, kernel_size=1)

    def forward(self, x):
        if x.ndim == 4:
            x = x.reshape(x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
        if self.global_context_att:
            mean = x.mean(dim=-1, keepdim=True).expand_as(x)
            std = torch.sqrt(x.var(dim=-1, keepdim=True, unbiased=True)
                             + 1e-10).expand_as(x)
            x_in = torch.cat([x, mean, std], dim=1)
        else:
            x_in = x
        alpha = torch.tanh(self.linear1(x_in))
        alpha = torch.softmax(self.linear2(alpha), dim=2)
        mean = torch.sum(alpha * x, dim=2)
        var = torch.sum(alpha * x * x, dim=2) - mean * mean
        std = torch.sqrt(var.clamp(min=1e-10))
        return torch.cat([mean, std], dim=1)
