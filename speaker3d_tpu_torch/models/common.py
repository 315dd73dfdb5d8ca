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


def trunk_freq(feat_dim: int, stride2_stages: int = 3) -> int:
    """Frequency bins left after ``stride2_stages`` stride-2, pad-1, 3x3
    stages (ceil(f / 2) each)."""
    f = feat_dim
    for _ in range(stride2_stages):
        f = (f + 1) // 2
    return f


def add_embedding_layers(module: nn.Module, stats_dim: int,
                         embedding_size: int, two_emb_layer: bool) -> None:
    """The reference's embedding layers after pooling, under its names:
    ``seg_1`` (Linear), and with ``two_emb_layer`` ``seg_bn_1`` (affine-free
    BatchNorm) and ``seg_2`` (Linear)."""
    module.seg_1 = nn.Linear(stats_dim, embedding_size)
    if two_emb_layer:
        module.seg_bn_1 = batch_norm1d(embedding_size, affine=False)
        module.seg_2 = nn.Linear(embedding_size, embedding_size)


def embedding_layers(module: nn.Module, stats):
    """``seg_1``, then ReLU -> ``seg_bn_1`` -> ``seg_2`` where the module has
    a second embedding layer."""
    embed_a = module.seg_1(stats)
    if not hasattr(module, "seg_2"):
        return embed_a
    return module.seg_2(module.seg_bn_1(torch.relu(embed_a)))
