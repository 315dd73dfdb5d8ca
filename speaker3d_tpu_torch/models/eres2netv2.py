"""ERes2NetV2 speaker-embedding backbone (PyTorch, NCHW).

The counterpart of ``speaker3d_tpu/models/eres2netv2.py``: a 2D ResNet-style
trunk over the fbank "image" [B, 1, F, T] with Res2Net split-cascade blocks,
AFF fusion in stages 3-4 plus one layer3->layer4 fusion, temporal pooling
(TSTP by default) and one or two embedding layers. Attribute names are the reference's state_dict keys
(``layer1.0.convs.0``, ``fuse34``, ``seg_1``), so reference checkpoints load
with ``strict=True``.

In eval mode every scale-2 block without AFF (layer1-2 of the 17.8M model)
runs through ``ops/kernels/res2_block_kernel.py`` in its input's dtype
(float32, or bfloat16 for a bf16 model on a bf16 input) with its BatchNorms
folded once per loaded weights, device and dtype; training mode keeps the
unfused path, and so does a block whose ``use_kernel`` is False (the int8
path of ``eval/quant.py``, whose convs must run). ``remat``
(training only) recomputes each residual block in the backward pass
(``models/common.py::remat_blocks``), as the JAX module's ``nn.remat`` per
block; the recomputation leaves the BatchNorm running statistics alone, so
they end as a plain step leaves them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import (
    add_embedding_layers, batch_norm2d, embedding_layers, relu20, remat_blocks,
    trunk_freq)
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult
from speaker3d_tpu_torch.ops.kernels.res2_block_kernel import (
    FIELDS, FoldedRes2Block, fold_res2_block, res2_block)


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
        self.use_kernel = True
        self._folds = {}
        self._frozen = False

    @property
    def fusable(self) -> bool:
        return self.scale == 2 and not self.use_aff

    def folded(self, dtype: torch.dtype = torch.float32):
        """The BN-folded weights in ``dtype``, folded once per loaded
        weights, device and dtype (``load_state_dict``, ``train()`` and a
        move or cast of the module drop them)."""
        if self._frozen:
            return FoldedRes2Block(*(getattr(self, f"fold_{name}")
                                     for name in FIELDS))
        key = (self.conv1.weight.device, dtype)
        if key in self._folds:
            return self._folds[key]
        with torch.no_grad():
            fold = fold_res2_block(
                {**dict(self.named_parameters()),
                 **dict(self.named_buffers())}, eps=self.bn1.eps,
                dtype=dtype)
        if torch._guards.detect_fake_mode() is None:
            # a trace's fake parameters never enter the cache
            self._folds[key] = fold
        return fold

    def freeze_folds(self, dtype: torch.dtype = torch.float32) -> None:
        """Hold the folds in ``dtype``, computed now, as non-persistent
        buffers (``fold_<field>``) that ``folded`` returns until
        ``thaw_folds``."""
        fold = self.folded(dtype)
        for name in FIELDS:
            self.register_buffer(f"fold_{name}", getattr(fold, name),
                                 persistent=False)
        self._frozen = True

    def thaw_folds(self) -> None:
        for name in FIELDS:
            delattr(self, f"fold_{name}")
        self._frozen = False

    def train(self, mode: bool = True):
        self._folds = {}
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self._folds = {}
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folds = {}
        return super()._load_from_state_dict(*args, **kwargs)

    def forward(self, x):
        if self.fusable and self.use_kernel and not self.training:
            return res2_block(x, self.folded(x.dtype), self.stride)
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
                 pooling_func: str = "TSTP", two_emb_layer: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
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
        out1 = remat_blocks(self.layer1, out, self.remat)
        out2 = remat_blocks(self.layer2, out1, self.remat)
        out3 = remat_blocks(self.layer3, out2, self.remat)
        out4 = remat_blocks(self.layer4, out3, self.remat)
        fuse34 = self.fuse34(out4, self.layer3_ds(out3))
        return embedding_layers(self, self.pool(fuse34))


@contextlib.contextmanager
def frozen_folds(model: nn.Module, dtype: torch.dtype = torch.float32):
    """Freeze the folds of every Res2 block of ``model`` that runs the
    kernel (``BasicBlockERes2NetV2.freeze_folds``) for the block, so a trace
    of the model takes them as buffers and not as arithmetic on its fake
    parameters; thaw them afterwards."""
    blocks = [m for m in model.modules()
              if isinstance(m, BasicBlockERes2NetV2) and m.fusable
              and m.use_kernel]
    for block in blocks:
        block.freeze_folds(dtype)
    try:
        yield blocks
    finally:
        for block in blocks:
            block.thaw_folds()


def eres2netv2_w24s4ep4(**kw) -> ERes2NetV2:
    """The fork's flagship diarization embedder (53.5M params)."""
    return ERes2NetV2(base_width=24, scale=4, expansion=4, **kw)
