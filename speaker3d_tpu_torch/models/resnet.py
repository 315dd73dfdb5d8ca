"""ResNet34 speaker-embedding backbone (PyTorch, NCHW).

The counterpart of ``speaker3d_tpu/models/resnet.py`` (reference:
speakerlab/models/resnet/ResNet.py, a wespeaker port): a plain BasicBlock
ResNet over the fbank image [B, 1, F, T], temporal pooling, one or two
embedding layers. Attribute names are the reference's state_dict keys. No
block of it is a Res2 block, so its trunk runs on cuDNN; the fbank of an
embed call runs through the fbank kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import (
    add_embedding_layers, batch_norm2d, embedding_layers, trunk_freq)
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult


class BasicBlock(nn.Module):
    """Two 3x3 convs with BatchNorm, a 1x1 projection shortcut where the
    shape changes."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = batch_norm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = batch_norm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                batch_norm2d(planes))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.shortcut(x))


class ResNet(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embedding_size].
    ResNet34 = num_blocks (3, 4, 6, 3)."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, feat_dim: int = 40,
                 embedding_size: int = 128, pooling_func: str = "TSTP",
                 two_emb_layer: bool = True):
        super().__init__()
        self.pool = get_pooling(pooling_func)
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(m_channels)
        in_planes = m_channels
        for idx, (mult, blocks, stride) in enumerate(
                zip((1, 2, 4, 8), num_blocks, (1, 2, 2, 2)), start=1):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(BasicBlock(in_planes, m_channels * mult, s))
                in_planes = m_channels * mult
            setattr(self, f"layer{idx}", nn.Sequential(*layers))
        add_embedding_layers(
            self, pooling_output_mult(pooling_func) * m_channels * 8
            * trunk_freq(feat_dim), embedding_size, two_emb_layer)

    def forward(self, x):
        x = x.transpose(1, 2).unsqueeze(1)          # [B, T, F] -> [B, 1, F, T]
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.layer4(self.layer3(self.layer2(self.layer1(out))))
        return embedding_layers(self, self.pool(out))
