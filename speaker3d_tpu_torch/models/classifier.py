"""Classification heads consumed by margin losses.

The counterpart of ``speaker3d_tpu/models/classifier.py`` (reference:
speakerlab/models/campplus/classifier.py): ``CosineClassifier`` gives the
cosine logits of L2-normalised embeddings against L2-normalised class
weights; ``LinearClassifier`` is a plain MLP head. The hidden blocks are the
reference's ``DenseLayer``s: a k=1 ``Conv1d`` applied to [B, C], then
BatchNorm (and ReLU in the linear head), under its state_dict names.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import batch_norm1d


class _DenseBlock(nn.Module):
    """``linear`` (k=1 Conv1d on [B, C]) -> ``nonlinear`` (BatchNorm, then
    ReLU where ``relu``)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool, relu: bool):
        super().__init__()
        self.linear = nn.Conv1d(in_dim, out_dim, 1, bias=bias)
        parts = [("batchnorm", batch_norm1d(out_dim))]
        if relu:
            parts.append(("relu", nn.ReLU()))
        self.nonlinear = nn.Sequential(OrderedDict(parts))

    def forward(self, x):
        return self.nonlinear(self.linear(x.unsqueeze(-1)).squeeze(-1))


def _l2norm(x, eps=1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


class CosineClassifier(nn.Module):
    """[B, input_dim] -> cosine logits [B, out_neurons]."""

    def __init__(self, input_dim: int, num_blocks: int = 0,
                 inter_dim: int = 512, out_neurons: int = 1000):
        super().__init__()
        self.blocks = nn.ModuleList()
        for _ in range(num_blocks):
            self.blocks.append(_DenseBlock(input_dim, inter_dim, bias=False,
                                           relu=False))
            input_dim = inter_dim
        self.weight = nn.Parameter(torch.empty(out_neurons, input_dim))
        nn.init.xavier_uniform_(self.weight)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return _l2norm(x) @ _l2norm(self.weight).T


class LinearClassifier(nn.Module):
    """ReLU, the hidden blocks, then a Linear to [B, out_neurons]."""

    def __init__(self, input_dim: int, num_blocks: int = 0,
                 inter_dim: int = 512, out_neurons: int = 1000):
        super().__init__()
        self.blocks = nn.ModuleList()
        for _ in range(num_blocks):
            self.blocks.append(_DenseBlock(input_dim, inter_dim, bias=True,
                                           relu=True))
            input_dim = inter_dim
        self.linear = nn.Linear(input_dim, out_neurons)

    def forward(self, x):
        x = torch.relu(x)
        for block in self.blocks:
            x = block(x)
        return self.linear(x)
