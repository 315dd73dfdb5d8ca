"""ERes2Net (base / large / huge) speaker-embedding backbone (PyTorch, NCHW).

The counterpart of ``speaker3d_tpu/models/eres2net.py``: the ERes2NetV2
trunk's blocks (``BasicBlockERes2NetV2``, reused) with a cascading
bottom-up fusion after every stage:

    fuse12   = AFF(out2, layer1_downsample(out1))
    fuse123  = AFF(out3, layer2_downsample(fuse12))
    fuse1234 = AFF(out4, layer3_downsample(fuse123))  -> pooling -> seg_1

The variants differ in (m_channels, base_width, scale, expansion):
base (32, 32, 2, 2), large (64, 32, 2, 2), huge (64, 24, 3, 4). In eval
mode the scale-2 blocks of layer1-2 (base and large) run through the Res2
block kernel, as in ERes2NetV2; huge is scale 3 and stays on cuDNN.
Attribute names are the reference's state_dict keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import (
    add_embedding_layers, batch_norm2d, embedding_layers, trunk_freq)
from speaker3d_tpu_torch.models.eres2netv2 import AFF, BasicBlockERes2NetV2
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult


class ERes2Net(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embedding_size].
    ``pooling_func``: TAP, TSDP or TSTP (every registry model uses TSTP with
    one embedding layer)."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, feat_dim: int = 80,
                 embedding_size: int = 192, base_width: int = 32,
                 scale: int = 2, expansion: int = 2,
                 pooling_func: str = "TSTP", two_emb_layer: bool = False):
        super().__init__()
        self.pool = get_pooling(pooling_func)
        m = m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(m)
        in_planes = m
        for idx, (mult, blocks, stride, use_aff) in enumerate(
                [(1, num_blocks[0], 1, False), (2, num_blocks[1], 2, False),
                 (4, num_blocks[2], 2, True), (8, num_blocks[3], 2, True)],
                start=1):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(BasicBlockERes2NetV2(
                    in_planes, m * mult, stride=s, base_width=base_width,
                    scale=scale, expansion=expansion, use_aff=use_aff))
                in_planes = m * mult * expansion
            setattr(self, f"layer{idx}", nn.Sequential(*layers))
        for idx, mult in ((1, 2), (2, 4), (3, 8)):
            setattr(self, f"layer{idx}_downsample", nn.Conv2d(
                m * mult // 2 * expansion, m * mult * expansion, 3, stride=2,
                padding=1, bias=False))
        self.fuse_mode12 = AFF(channels=m * 2 * expansion)
        self.fuse_mode123 = AFF(channels=m * 4 * expansion)
        self.fuse_mode1234 = AFF(channels=m * 8 * expansion)
        add_embedding_layers(
            self, pooling_output_mult(pooling_func) * m * 8 * expansion
            * trunk_freq(feat_dim), embedding_size, two_emb_layer)

    def forward(self, x):
        x = x.transpose(1, 2).unsqueeze(1)          # [B, T, F] -> [B, 1, F, T]
        out = torch.relu(self.bn1(self.conv1(x)))
        out1 = self.layer1(out)
        out2 = self.layer2(out1)
        fuse12 = self.fuse_mode12(out2, self.layer1_downsample(out1))
        out3 = self.layer3(out2)
        fuse123 = self.fuse_mode123(out3, self.layer2_downsample(fuse12))
        out4 = self.layer4(out3)
        fuse1234 = self.fuse_mode1234(out4, self.layer3_downsample(fuse123))
        return embedding_layers(self, self.pool(fuse1234))


def eres2net_base(**kw) -> ERes2Net:
    return ERes2Net(m_channels=32, base_width=32, scale=2, expansion=2, **kw)


def eres2net_large(**kw) -> ERes2Net:
    return ERes2Net(m_channels=64, base_width=32, scale=2, expansion=2, **kw)


def eres2net_huge(**kw) -> ERes2Net:
    return ERes2Net(m_channels=64, base_width=24, scale=3, expansion=4, **kw)
