"""Deep-FSMN voice-activity detector: per-frame speech logits on log-mel
fbank features.

The counterpart of ``speaker3d_tpu/models/fsmn_vad.py``. Each DFSMN layer
projects down, runs a per-channel FIR "memory" over ``lorder`` past and
``rorder`` future frames (a depthwise ``conv1d`` on the zero-padded
sequence), adds an identity skip from the previous layer's memory and
re-expands with ReLU. Submodule names are the Flax ones (``in_linear``,
``in_norm``, ``fsmn.{i}.proj/memory/expand``, ``out_linear``), so
``compat/flax_convert.py`` carries the weights both ways. The Flax
LayerNorm's epsilon is 1e-6, not torch's default 1e-5.

``lecun_init_`` draws the initial weights as Flax's defaults do (truncated
normal over the fan-in for every Dense and Conv kernel, zero biases,
LayerNorm 1 / 0) from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class FSMNBlock(nn.Module):
    """One DFSMN layer: project down, depthwise temporal FIR memory with an
    identity skip from the previous memory, re-expand with ReLU."""

    def __init__(self, hidden_dim: int, proj_dim: int, lorder: int,
                 rorder: int):
        super().__init__()
        self.lorder, self.rorder = lorder, rorder
        self.proj = nn.Linear(hidden_dim, proj_dim, bias=False)
        self.memory = nn.Conv1d(proj_dim, proj_dim, lorder + rorder + 1,
                                groups=proj_dim, bias=False)
        self.expand = nn.Linear(proj_dim, hidden_dim)

    def forward(self, h, prev_mem=None):
        """h [B, T, hidden] -> (out [B, T, hidden], mem [B, T, proj])."""
        p = self.proj(h)
        # asymmetric zero padding, then a cross-correlation like Flax's
        fir = self.memory(F.pad(p.transpose(1, 2), (self.lorder, self.rorder)))
        mem = p + fir.transpose(1, 2)
        if prev_mem is not None:
            mem = mem + prev_mem
        return F.relu(self.expand(mem)), mem


class FSMNTrunk(nn.Module):
    """Dense -> LayerNorm -> ReLU -> ``num_layers`` DFSMN layers -> Dense
    with ``out_dim`` outputs per frame."""

    def __init__(self, feat_dim: int, hidden_dim: int, proj_dim: int,
                 num_layers: int, lorder: int, rorder: int, out_dim: int):
        super().__init__()
        self.feat_dim = feat_dim
        self.num_layers = num_layers
        self.lorder, self.rorder = lorder, rorder
        self.in_linear = nn.Linear(feat_dim, hidden_dim)
        self.in_norm = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.fsmn = nn.ModuleList(
            FSMNBlock(hidden_dim, proj_dim, lorder, rorder)
            for _ in range(num_layers))
        self.out_linear = nn.Linear(hidden_dim, out_dim)

    @property
    def receptive_field(self) -> tuple:
        """(left, right) context consumed per output frame."""
        return (self.lorder * self.num_layers, self.rorder * self.num_layers)

    def trunk(self, x):
        h = F.relu(self.in_norm(self.in_linear(x)))
        mem = None
        for block in self.fsmn:
            h, mem = block(h, mem)
        return self.out_linear(h)


class FSMNVad(FSMNTrunk):
    """Per-frame speech/non-speech classifier.

    Input: [B, T, feat_dim] log-mel fbank. Output: [B, T] speech logits
    (sigmoid -> P(speech))."""

    def __init__(self, feat_dim: int = 80, hidden_dim: int = 128,
                 proj_dim: int = 64, num_layers: int = 4, lorder: int = 20,
                 rorder: int = 5):
        super().__init__(feat_dim, hidden_dim, proj_dim, num_layers, lorder,
                         rorder, out_dim=1)

    def forward(self, x):
        return self.trunk(x).squeeze(-1)


def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation, drawn from ``generator`` in module
    order: Linear and Conv weights from a normal truncated at two standard
    deviations with variance 1 / fan_in (``lecun_normal``; the fan-in is
    the input width times the kernel's size, a depthwise kernel's its
    size), biases 0, LayerNorm weight 1, bias 0."""
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d,
                                   nn.Conv3d)):
                w = module.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model
