"""x-vector (TDNN) speaker-embedding backbone (PyTorch, NCT).

The counterpart of ``speaker3d_tpu/models/xvector.py`` (reference:
speakerlab/models/xvector/TDNN.py, a wespeaker port): five unpadded TDNN
layers (conv -> ReLU -> affine-free BatchNorm, Kaldi's order), temporal
pooling and a linear embedding. Attribute names are the reference's
state_dict keys. Its trunk runs on cuDNN; the fbank of an embed call runs
through the fbank kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from speaker3d_tpu_torch.models.common import batch_norm1d
from speaker3d_tpu_torch.models.pooling import get_pooling, pooling_output_mult


class TdnnLayer(nn.Module):
    """Conv1d (no padding, dilated) -> ReLU -> BatchNorm(affine=False)."""

    def __init__(self, in_dim: int, out_dim: int, context_size: int,
                 dilation: int = 1):
        super().__init__()
        self.conv_1d = nn.Conv1d(in_dim, out_dim, context_size,
                                 dilation=dilation)
        self.bn = batch_norm1d(out_dim, affine=False)

    def forward(self, x):
        return self.bn(torch.relu(self.conv_1d(x)))


class Xvector(nn.Module):
    """Input: log-mel features [B, T, feat_dim]. Output: [B, embed_dim].
    4.25M parameters at the default 40 mel bins, 4.35M at the recipe's 80."""

    def __init__(self, feat_dim: int = 40, hid_dim: int = 512,
                 stats_dim: int = 1500, embed_dim: int = 512,
                 pooling_func: str = "TSTP"):
        super().__init__()
        self.pool = get_pooling(pooling_func)
        self.frame_1 = TdnnLayer(feat_dim, hid_dim, 5, 1)
        self.frame_2 = TdnnLayer(hid_dim, hid_dim, 3, 2)
        self.frame_3 = TdnnLayer(hid_dim, hid_dim, 3, 3)
        self.frame_4 = TdnnLayer(hid_dim, hid_dim, 1, 1)
        self.frame_5 = TdnnLayer(hid_dim, stats_dim, 1, 1)
        self.seg_1 = nn.Linear(pooling_output_mult(pooling_func) * stats_dim,
                               embed_dim)

    def forward(self, x):
        out = x.transpose(1, 2)                      # [B, T, F] -> [B, F, T]
        for layer in (self.frame_1, self.frame_2, self.frame_3, self.frame_4,
                      self.frame_5):
            out = layer(out)
        return self.seg_1(self.pool(out))
