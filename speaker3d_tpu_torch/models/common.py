"""Shared model helpers."""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5  # Flax BatchNorm's default epsilon, which the JAX models use


def batch_norm2d(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def batch_norm1d(channels: int, affine: bool = True) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(channels, eps=BN_EPS, affine=affine)


def relu20(x):
    """The reference's ReLU: Hardtanh(0, 20)."""
    return torch.clamp(x, 0.0, 20.0)
