"""Res2Net speaker-embedding backbone (PyTorch, NCHW).

The counterpart of ``speaker3d_tpu/models/res2net.py`` (reference:
speakerlab/models/res2net/Res2Net.py, a wespeaker port): a plain Res2Net
trunk without AFF fusion. Within a block only the first ``scale - 1``
splits are convolved (each after adding the previous split's output); the
last split passes through unconvolved. Activations inside the blocks are
the reference's ReLU clipped at 20. Attribute names are the reference's
state_dict keys.

Its blocks are not the Res2 block kernel's (that kernel convolves every
split of an ERes2NetV2/ERes2Net block, with a fused shortcut), so the trunk
runs on cuDNN; the fbank of an embed call runs through the fbank kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import (
    add_embedding_layers, batch_norm2d, embedding_layers, relu20, trunk_freq)
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult


class BasicBlockRes2Net(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 32, scale: int = 2, expansion: int = 2):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.nums = width, scale - 1
        self.conv1 = nn.Conv2d(in_planes, width * scale, 1, stride=stride,
                               bias=False)
        self.bn1 = batch_norm2d(width * scale)
        self.convs = nn.ModuleList(
            nn.Conv2d(width, width, 3, padding=1, bias=False)
            for _ in range(self.nums))
        self.bns = nn.ModuleList(batch_norm2d(width) for _ in range(self.nums))
        self.conv3 = nn.Conv2d(width * scale, planes * expansion, 1,
                               bias=False)
        self.bn3 = batch_norm2d(planes * expansion)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, expansion * planes, 1, stride=stride,
                          bias=False),
                batch_norm2d(expansion * planes))

    def forward(self, x):
        out = relu20(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        pieces, sp = [], None
        for i in range(self.nums):
            sp = splits[i] if i == 0 else sp + splits[i]
            sp = relu20(self.bns[i](self.convs[i](sp)))
            pieces.append(sp)
        pieces.append(splits[self.nums])
        out = self.bn3(self.conv3(torch.cat(pieces, dim=1)))
        return relu20(out + self.shortcut(x))


class Res2Net(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embedding_size].
    The default configuration has 4.03M parameters."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, feat_dim: int = 80,
                 embedding_size: int = 192, base_width: int = 32,
                 scale: int = 2, expansion: int = 2,
                 pooling_func: str = "TSTP", two_emb_layer: bool = False):
        super().__init__()
        self.pool = get_pooling(pooling_func)
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(m_channels)
        in_planes = m_channels
        for idx, (mult, blocks, stride) in enumerate(
                zip((1, 2, 4, 8), num_blocks, (1, 2, 2, 2)), start=1):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(BasicBlockRes2Net(
                    in_planes, m_channels * mult, stride=s,
                    base_width=base_width, scale=scale, expansion=expansion))
                in_planes = m_channels * mult * expansion
            setattr(self, f"layer{idx}", nn.Sequential(*layers))
        add_embedding_layers(
            self, pooling_output_mult(pooling_func) * m_channels * 8
            * expansion * trunk_freq(feat_dim), embedding_size, two_emb_layer)

    def forward(self, x):
        x = x.transpose(1, 2).unsqueeze(1)          # [B, T, F] -> [B, 1, F, T]
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        return embedding_layers(self, self.pool(out))
