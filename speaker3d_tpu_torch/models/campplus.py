"""CAM++ (CAMPPlus) speaker-embedding backbone (PyTorch, [B, C, T]).

The counterpart of ``speaker3d_tpu/models/campplus.py``: a 2D-conv FCM head
(frequency /8, channels and frequency merged in (C, F') order) feeding a
densely connected D-TDNN whose every dense layer is gated by a
context-aware mask (CAM), statistics pooling (unbiased std), and a k=1
``Conv1d`` embedding layer with an affine-free BatchNorm. Attribute names
are the reference's state_dict keys (``head.layer1.0.conv1``,
``xvector.block1.tdnnd1.cam_layer.linear_local``,
``xvector.dense.nonlinear.batchnorm``). ``memory_efficient`` (training
only) recomputes each dense layer in the backward pass, as the JAX
module's ``nn.remat`` per ``CAMDenseTDNNLayer``
(``models/common.py::checkpointed``: the recomputation leaves the
BatchNorm running statistics alone).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.models.common import (
    batch_norm1d, batch_norm2d, checkpointed)


class NonLinear(nn.Sequential):
    """'batchnorm-relu'-style config string applied in order; 'batchnorm_'
    is the affine-free BatchNorm."""

    def __init__(self, config_str: str, channels: int):
        parts = []
        for part in config_str.split("-"):
            if part == "relu":
                parts.append(("relu", nn.ReLU()))
            elif part in ("batchnorm", "batchnorm_"):
                parts.append(("batchnorm",
                              batch_norm1d(channels, affine=part == "batchnorm")))
            else:
                raise ValueError(f"unexpected nonlinear part {part!r}")
        super().__init__(OrderedDict(parts))


class BasicResBlock(nn.Module):
    """2D residual block with a frequency-only stride. x: [B, C, F, T]."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=(stride, 1),
                               padding=1, bias=False)
        self.bn1 = batch_norm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = batch_norm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=(stride, 1), bias=False),
                batch_norm2d(planes))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.shortcut(x))


class FCM(nn.Module):
    """Front-end convolution module: [B, T, F] -> [B, C*F/8, T]."""

    def __init__(self, num_blocks=(2, 2), m_channels: int = 32,
                 feat_dim: int = 80):
        super().__init__()
        m = m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(m)
        for li, blocks in enumerate(num_blocks, start=1):
            setattr(self, f"layer{li}", nn.Sequential(*(
                BasicResBlock(m, m, s) for s in [2] + [1] * (blocks - 1))))
        self.conv2 = nn.Conv2d(m, m, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = batch_norm2d(m)
        self.out_channels = m * ((((feat_dim + 1) // 2 + 1) // 2 + 1) // 2)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x.transpose(1, 2).unsqueeze(1))))
        out = self.layer2(self.layer1(out))
        out = torch.relu(self.bn2(self.conv2(out)))
        b, c, f, t = out.shape
        return out.reshape(b, c * f, t)  # (C, F') order, as the reference


def seg_avg_pool_expand(x, seg_len: int = 100):
    """Ceil-mode ``seg_len``-frame average over [B, C, T], expanded back to
    T frames: the last, partial segment is divided by its real frame count
    (``avg_pool1d`` without padding counts only the frames it holds)."""
    seg = F.avg_pool1d(x, seg_len, seg_len, ceil_mode=True)
    return seg.repeat_interleave(seg_len, dim=-1)[..., :x.shape[-1]]


class CAMLayer(nn.Module):
    """Context-aware mask: sigmoid(MLP(global mean + segment mean)) gates a
    local conv."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, reduction: int = 2):
        super().__init__()
        self.linear_local = nn.Conv1d(
            bn_channels, out_channels, kernel_size, dilation=dilation,
            padding=(kernel_size - 1) // 2 * dilation, bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.linear_local(x)
        context = x.mean(-1, keepdim=True) + seg_avg_pool_expand(x)
        context = torch.relu(self.linear1(context))
        return y * torch.sigmoid(self.linear2(context))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int = 1,
                 config_str: str = "batchnorm-relu"):
        super().__init__()
        self.nonlinear1 = NonLinear(config_str, in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_channels, 1, bias=False)
        self.nonlinear2 = NonLinear(config_str, bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size,
                                  dilation)

    def forward(self, x):
        x = self.nonlinear2(self.linear1(self.nonlinear1(x)))
        return self.cam_layer(x)


class CAMDenseTDNNBlock(nn.ModuleList):
    """Dense connectivity: each layer's output is concatenated onto its
    input along channels. ``memory_efficient``: each layer recomputed in
    the backward (training with autograd on)."""

    def __init__(self, num_layers: int, in_channels: int, out_channels: int,
                 bn_channels: int, kernel_size: int, dilation: int,
                 config_str: str):
        super().__init__()
        self.memory_efficient = False
        for i in range(num_layers):
            self.add_module(f"tdnnd{i + 1}", CAMDenseTDNNLayer(
                in_channels + i * out_channels, out_channels, bn_channels,
                kernel_size, dilation, config_str))

    def forward(self, x):
        remat = (self.memory_efficient and self.training
                 and torch.is_grad_enabled())
        for layer in self:
            x = torch.cat([x, checkpointed(layer, x) if remat else layer(x)],
                          dim=1)
        return x


class TDNNLayer(nn.Module):
    """conv -> nonlinear."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1,
                 config_str: str = "batchnorm-relu"):
        super().__init__()
        self.linear = nn.Conv1d(
            in_channels, out_channels, kernel_size, stride=stride,
            dilation=dilation, padding=(kernel_size - 1) // 2 * dilation,
            bias=False)
        self.nonlinear = NonLinear(config_str, out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


class TransitLayer(nn.Module):
    """nonlinear -> 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int, config_str: str):
        super().__init__()
        self.nonlinear = NonLinear(config_str, in_channels)
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class StatsPool(nn.Module):
    """Mean ‖ unbiased std over time: [B, C, T] -> [B, 2C]. The std is the
    square root of the variance, as the JAX module takes it: in bf16 the
    variance is rounded before the root."""

    def forward(self, x):
        std = torch.sqrt(x.var(dim=-1, unbiased=True))
        return torch.cat([x.mean(dim=-1), std], dim=-1)


class DenseLayer(nn.Module):
    """A k=1 ``Conv1d`` (the reference's layout) on [B, C], then an
    affine-free BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.nonlinear = NonLinear("batchnorm_", out_channels)

    def forward(self, x):
        return self.nonlinear(self.linear(x.unsqueeze(-1)).squeeze(-1))


class CAMPPlus(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embedding_size].
    7.2M parameters at the default config."""

    # the JAX module's Dense (``compat/flax_convert.py``)
    flax_dense_names = ("xvector.dense.linear",)

    def __init__(self, feat_dim: int = 80, embedding_size: int = 512,
                 growth_rate: int = 32, bn_size: int = 4,
                 init_channels: int = 128, config_str: str = "batchnorm-relu",
                 memory_efficient: bool = False):
        super().__init__()
        self.head = FCM(feat_dim=feat_dim)
        layers = [("tdnn", TDNNLayer(self.head.out_channels, init_channels, 5,
                                     stride=2, config_str=config_str))]
        channels = init_channels
        for i, (num_layers, kernel_size, dilation) in enumerate(
                zip((12, 24, 16), (3, 3, 3), (1, 2, 2)), start=1):
            layers.append((f"block{i}", CAMDenseTDNNBlock(
                num_layers, channels, growth_rate, bn_size * growth_rate,
                kernel_size, dilation, config_str)))
            channels += num_layers * growth_rate
            layers.append((f"transit{i}", TransitLayer(
                channels, channels // 2, config_str)))
            channels //= 2
        layers += [("out_nonlinear", NonLinear(config_str, channels)),
                   ("stats", StatsPool()),
                   ("dense", DenseLayer(channels * 2, embedding_size))]
        self.xvector = nn.Sequential(OrderedDict(layers))
        self.memory_efficient = memory_efficient

    @property
    def memory_efficient(self) -> bool:
        return self.xvector.block1.memory_efficient

    @memory_efficient.setter
    def memory_efficient(self, on: bool) -> None:
        for i in (1, 2, 3):
            getattr(self.xvector, f"block{i}").memory_efficient = bool(on)

    @property
    def flax_joined_names(self) -> tuple:
        """The JAX module's dotted submodule names: ``xvector.<child>``, and
        under a dense block, transit or dense layer ``xvector.<child>.<sub>``
        (``xvector.block1.tdnnd1``)."""
        names = []
        for child, mod in self.xvector.named_children():
            names.append(f"xvector.{child}")
            if isinstance(mod, (CAMDenseTDNNBlock, TransitLayer, DenseLayer)):
                names += [f"xvector.{child}.{sub}"
                          for sub, _ in mod.named_children()]
        return tuple(names)

    def forward(self, x):
        return self.xvector(self.head(x))
