"""ECAPA-TDNN speaker-embedding backbone (PyTorch, [B, C, T]).

The counterpart of ``speaker3d_tpu/models/ecapa_tdnn.py`` (a SpeechBrain
port): a TDNN stem, three SE-Res2Net blocks with dilated convs, multi-layer
feature aggregation, attentive statistics pooling with global context, BN
and a k=1 projection to the embedding. Module names are the reference's
nested wrappers (``blocks.0.conv.conv``, ``blocks.1.tdnn1.norm.norm``,
``asp_bn.norm``, ``fc.conv``), so reference checkpoints load with
``strict=True``. What differs from the other backbones:

- SpeechBrain's "same" padding is *reflect* padding, split ``total // 2``
  before and ``total - total // 2`` after;
- a TDNNBlock is conv -> ReLU -> BatchNorm (the norm after the activation);
- in the Res2Net chain the first chunk passes through unconvolved.

Static-shape path only: the reference's ``lengths=None`` (an all-ones
mask), which is what chunked inference uses.

``ssl_input_norm=True`` is the SSL trainers' variant (RDINO, SDPN): its
input is a *linear* mel spectrogram (``ops/melspec.py``), and the forward
first takes ``log(x + 1e-6)`` and a per-utterance instance norm over time
(biased variance, eps 1e-5), detached from the graph.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.models.common import batch_norm1d


class SBConv1d(nn.Module):
    """SpeechBrain's Conv1d with "same" reflect padding. x: [B, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        total = dilation * (kernel_size - 1)
        self.pad = (total // 2, total - total // 2)
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              dilation=dilation)

    def forward(self, x):
        if self.pad != (0, 0):
            x = F.pad(x, self.pad, mode="reflect")
        return self.conv(x)


class BatchNorm1d(nn.Module):
    """SpeechBrain's wrapper, kept for its ``norm`` key."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = batch_norm1d(channels)

    def forward(self, x):
        return self.norm(x)


class TDNNBlock(nn.Module):
    """conv -> relu -> batchnorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.conv = SBConv1d(in_channels, out_channels, kernel_size, dilation)
        self.norm = BatchNorm1d(out_channels)

    def forward(self, x):
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Chunk 0 passes through; chunk i > 0 is TDNN(x_i + y_{i-1}) (x_1
    alone)."""

    def __init__(self, in_channels: int, out_channels: int, scale: int = 8,
                 kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.scale = scale
        self.blocks = nn.ModuleList(
            TDNNBlock(in_channels // scale, out_channels // scale,
                      kernel_size, dilation) for _ in range(scale - 1))

    def forward(self, x):
        ys = []
        for i, x_i in enumerate(torch.chunk(x, self.scale, dim=1)):
            if i == 0:
                y_i = x_i
            elif i == 1:
                y_i = self.blocks[i - 1](x_i)
            else:
                y_i = self.blocks[i - 1](x_i + y_i)
            ys.append(y_i)
        return torch.cat(ys, dim=1)


class SEBlock(nn.Module):
    """Squeeze-excitation over the global mean."""

    def __init__(self, in_channels: int, se_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = SBConv1d(in_channels, se_channels, 1)
        self.conv2 = SBConv1d(se_channels, out_channels, 1)

    def forward(self, x):
        s = torch.relu(self.conv1(x.mean(dim=-1, keepdim=True)))
        return torch.sigmoid(self.conv2(s)) * x


def _stats(x, w, eps: float = 1e-12):
    """Weighted mean and std over time, std clamped at ``eps`` before the
    root."""
    mean = (w * x).sum(dim=-1)
    std = torch.sqrt(torch.clamp(
        (w * (x - mean.unsqueeze(-1)) ** 2).sum(dim=-1), min=eps))
    return mean, std


class AttentiveStatisticsPooling(nn.Module):
    """x: [B, C, T] -> [B, 2C]."""

    def __init__(self, channels: int, attention_channels: int = 128,
                 global_context: bool = True):
        super().__init__()
        self.global_context = global_context
        self.tdnn = TDNNBlock(channels * (3 if global_context else 1),
                              attention_channels, 1)
        self.conv = SBConv1d(attention_channels, channels, 1)

    def forward(self, x):
        attn = x
        if self.global_context:
            t = x.shape[-1]
            mean, std = _stats(x, torch.full_like(x, 1.0 / t))
            attn = torch.cat([x, mean.unsqueeze(-1).expand_as(x),
                              std.unsqueeze(-1).expand_as(x)], dim=1)
        attn = self.conv(torch.tanh(self.tdnn(attn)))
        mean, std = _stats(x, torch.softmax(attn, dim=-1))
        return torch.cat([mean, std], dim=1)


class SERes2NetBlock(nn.Module):
    """TDNN 1x1 -> Res2Net -> TDNN 1x1 -> SE, plus the residual."""

    def __init__(self, in_channels: int, out_channels: int,
                 res2net_scale: int = 8, se_channels: int = 128,
                 kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1)
        self.res2net_block = Res2NetBlock(out_channels, out_channels,
                                          res2net_scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1)
        self.se_block = SEBlock(out_channels, se_channels, out_channels)
        self.shortcut = (SBConv1d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        x = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(x) + residual


class ECAPA_TDNN(nn.Module):
    """Input: log-mel features [B, T, input_size] (linear mel with
    ``ssl_input_norm``). Output: [B, lin_neurons]. The released checkpoints
    use channels (1024, 1024, 1024, 1024, 3072)."""

    # the Flax submodule names that hold a dot besides an index, and the
    # k=1 convs that the JAX module holds as Dense layers
    # (``compat/flax_convert.py::flax_from_state_dict``)
    flax_joined_names = ("norm.norm", "asp_bn.norm", "fc.conv")
    flax_dense_names = ("fc.conv",)

    def __init__(self, input_size: int = 80, lin_neurons: int = 192,
                 channels: Sequence[int] = (512, 512, 512, 512, 1536),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1),
                 attention_channels: int = 128, res2net_scale: int = 8,
                 se_channels: int = 128, global_context: bool = True,
                 ssl_input_norm: bool = False):
        super().__init__()
        self.ssl_input_norm = ssl_input_norm
        self.blocks = nn.ModuleList([TDNNBlock(
            input_size, channels[0], kernel_sizes[0], dilations[0])])
        for i in range(1, len(channels) - 1):
            self.blocks.append(SERes2NetBlock(
                channels[i - 1], channels[i], res2net_scale, se_channels,
                kernel_sizes[i], dilations[i]))
        self.mfa = TDNNBlock(sum(channels[1:-1]), channels[-1],
                             kernel_sizes[-1], dilations[-1])
        self.asp = AttentiveStatisticsPooling(
            channels[-1], attention_channels, global_context)
        self.asp_bn = BatchNorm1d(channels[-1] * 2)
        self.fc = SBConv1d(channels[-1] * 2, lin_neurons, 1)

    def forward(self, x):
        if self.ssl_input_norm:
            x = torch.log(x + 1e-6)
            mean = x.mean(dim=1, keepdim=True)
            var = x.var(dim=1, keepdim=True, unbiased=False)
            x = ((x - mean) / torch.sqrt(var + 1e-5)).detach()
        x = x.transpose(1, 2)                  # [B, T, F] -> [B, F, T]
        xl = []
        for block in self.blocks:
            x = block(x)
            xl.append(x)
        x = self.mfa(torch.cat(xl[1:], dim=1))
        x = self.asp_bn(self.asp(x))
        return self.fc(x.unsqueeze(-1)).squeeze(-1)
