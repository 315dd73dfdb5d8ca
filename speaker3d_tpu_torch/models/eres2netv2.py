"""ERes2NetV2 speaker-embedding backbone (PyTorch, NCHW).

The counterpart of ``speaker3d_tpu/models/eres2netv2.py``: a 2D ResNet-style
trunk over the fbank "image" [B, 1, F, T] with Res2Net split-cascade blocks,
AFF fusion in stages 3-4 plus one layer3->layer4 fusion, temporal pooling
(TSTP by default) and one or two embedding layers. Attribute names are the reference's state_dict keys
(``layer1.0.convs.0``, ``fuse34``, ``seg_1``), so reference checkpoints load
with ``strict=True``.

In eval mode every scale-2 block without AFF (layer1-2 of the 17.8M model)
runs through ``ops/kernels/res2_block_kernel.py`` with its BatchNorms folded
once per loaded weights; training mode keeps the unfused path.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import (
    add_embedding_layers, batch_norm2d, embedding_layers, relu20, trunk_freq)
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult
from speaker3d_tpu_torch.ops.kernels.res2_block_kernel import (
    fold_res2_block, res2_block)


class AFF(nn.Module):
    """Attentional feature fusion: gate = 1 + tanh(MLP(x ‖ y));
    out = x*gate + y*(2-gate)."""

    def __init__(self, channels: int, r: int = 4):
        super().__init__()
        inter = channels // r
        self.local_att = nn.Sequential(
            nn.Conv2d(2 * channels, inter, 1),
            batch_norm2d(inter),
            nn.SiLU(),
            nn.Conv2d(inter, channels, 1),
            batch_norm2d(channels),
        )

    def forward(self, x, ds_y):
        att = 1.0 + torch.tanh(self.local_att(torch.cat([x, ds_y], dim=1)))
        return x * att + ds_y * (2.0 - att)


class BasicBlockERes2NetV2(nn.Module):
    """Res2Net bottleneck block; optional AFF fusion between splits."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 base_width: int = 26, scale: int = 2, expansion: int = 2,
                 use_aff: bool = False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.scale, self.stride = width, scale, stride
        self.use_aff = use_aff
        self.conv1 = nn.Conv2d(in_planes, width * scale, 1, stride=stride,
                               bias=False)
        self.bn1 = batch_norm2d(width * scale)
        self.convs = nn.ModuleList(
            nn.Conv2d(width, width, 3, padding=1, bias=False)
            for _ in range(scale))
        self.bns = nn.ModuleList(batch_norm2d(width) for _ in range(scale))
        if use_aff:
            self.fuse_models = nn.ModuleList(
                AFF(channels=width) for _ in range(scale - 1))
        self.conv3 = nn.Conv2d(width * scale, planes * expansion, 1, bias=False)
        self.bn3 = batch_norm2d(planes * expansion)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, expansion * planes, 1, stride=stride,
                          bias=False),
                batch_norm2d(expansion * planes))
        self._fold = None

    @property
    def fusable(self) -> bool:
        return self.scale == 2 and not self.use_aff

    def folded(self):
        """The BN-folded weights, folded once per loaded weights and device
        (``load_state_dict`` and ``train()`` drop them)."""
        dev = self.conv1.weight.device
        if self._fold is None or self._fold.b1.device != dev:
            with torch.no_grad():
                self._fold = fold_res2_block(
                    {**dict(self.named_parameters()),
                     **dict(self.named_buffers())}, eps=self.bn1.eps)
        return self._fold

    def train(self, mode: bool = True):
        self._fold = None
        return super().train(mode)

    def _load_from_state_dict(self, *args, **kwargs):
        self._fold = None
        return super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x):
        if self.fusable and not self.training:
            return res2_block(x, self.folded(), self.stride)
        out = relu20(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        pieces = []
        sp = None
        for i in range(self.scale):
            if i == 0:
                sp = splits[0]
            elif self.use_aff:
                sp = self.fuse_models[i - 1](sp, splits[i])
            else:
                sp = sp + splits[i]
            sp = relu20(self.bns[i](self.convs[i](sp)))
            pieces.append(sp)
        out = self.bn3(self.conv3(torch.cat(pieces, dim=1)))
        return relu20(out + self.shortcut(x))


class ERes2NetV2(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embedding_size].
    Default config = 17.8M params; w24s4ep4 uses base_width=24, scale=4,
    expansion=4. ``pooling_func``: TAP, TSDP or TSTP (both registry models
    use TSTP with one embedding layer)."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 64, feat_dim: int = 80,
                 embedding_size: int = 192, base_width: int = 26,
                 scale: int = 2, expansion: int = 2,
                 pooling_func: str = "TSTP", two_emb_layer: bool = False):
        super().__init__()
        self.pool = get_pooling(pooling_func)
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = batch_norm2d(m_channels)
        in_planes = m_channels
        for idx, (mult, blocks, stride, use_aff) in enumerate(
                [(1, num_blocks[0], 1, False), (2, num_blocks[1], 2, False),
                 (4, num_blocks[2], 2, True), (8, num_blocks[3], 2, True)],
                start=1):
            layers = []
            for s in [stride] + [1] * (blocks - 1):
                layers.append(BasicBlockERes2NetV2(
                    in_planes, m_channels * mult, stride=s,
                    base_width=base_width, scale=scale, expansion=expansion,
                    use_aff=use_aff))
                in_planes = m_channels * mult * expansion
            setattr(self, f"layer{idx}", nn.Sequential(*layers))
        top = m_channels * 8 * expansion
        self.layer3_ds = nn.Conv2d(m_channels * 4 * expansion, top, 3,
                                   stride=2, padding=1, bias=False)
        self.fuse34 = AFF(channels=top)
        add_embedding_layers(
            self, pooling_output_mult(pooling_func) * top * trunk_freq(feat_dim),
            embedding_size, two_emb_layer)

    def forward(self, x):
        x = x.transpose(1, 2).unsqueeze(1)          # [B, T, F] -> [B, 1, F, T]
        out = torch.relu(self.bn1(self.conv1(x)))
        out1 = self.layer1(out)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        fuse34 = self.fuse34(out4, self.layer3_ds(out3))
        return embedding_layers(self, self.pool(fuse34))


def eres2netv2_w24s4ep4(**kw) -> ERes2NetV2:
    """The fork's flagship diarization embedder (53.5M params)."""
    return ERes2NetV2(base_width=24, scale=4, expansion=4, **kw)
