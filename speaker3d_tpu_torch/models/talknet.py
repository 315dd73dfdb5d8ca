"""TalkNet audio-visual active speaker detection.

The counterpart of ``speaker3d_tpu/models/talknet.py``, with the torch
toolkit's state_dict names (``audioEncoder.layer1.0.se.fc.0.weight``,
``visualFrontend.frontend3D.0.weight``, ``visualTCN.net.0.net.3.weight``,
``crossA2V.self_attn.in_proj_weight``), so a reference ``talkNet``
state_dict loads with ``strict=True``:

- audio encoder: an SE-ResNet34 over the MFCC as an image [B, 1, 13, 4T]
  (``conv1`` 7x7 at stride (2, 1); conv -> ReLU -> ``bn1`` inside
  ``SEBasicBlock``; the SE gate over the global mean), the mean over
  frequency after layer4 -> [B, T, 128];
- visual frontend: one 3-D convolution over [1, 1, B·T, 112, 112], the
  batch and time flattened into its depth axis as the reference does (at
  B > 1 its 5-frame kernel crosses clip boundaries), a max pool padded with
  -inf, a lip-reading ResNet18 and the mean of its last 4x4 map -> [B, T,
  512]; its BatchNorms use eps 1e-3, every other BatchNorm 1e-5 (all with
  Flax's momentum 0.99, ``models/common.py``);
- visual TCN: five depthwise-separable blocks (ReLU, BatchNorm, a
  depthwise conv over 512 groups, a PReLU with one alpha, the global layer
  norm over (C, T) with eps 1e-8 inside the square root, a 1x1 conv, the
  residual), then ``visualConv1D`` -> [B, T, 128];
- cross attention with q from ``tar`` and k, v from ``src``, the residual
  updating ``src`` (``crossA2V(a, v)``, ``crossV2A(v, a)``), self attention
  on the 256-d concatenation, 8 heads, LayerNorms with Flax's eps 1e-6 (the
  torch toolkit trains with 1e-5); three 2-way heads ``fcAV``, ``fcA``,
  ``fcV``.

Dropout is left out (inference). Frames are normalised as ``(v / 255 -
0.4161) / 0.1688``.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.models.common import (
    batch_norm1d, batch_norm2d, batch_norm3d)

LN_EPS = 1e-6           # flax.linen.LayerNorm's default
VISUAL_BN_EPS = 1e-3    # the visual frontend's BatchNorms


class AttentionLayer(nn.Module):
    """q from ``tar``, k and v from ``src``; the residual updates ``src``."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, nhead,
                                               batch_first=True)
        self.linear1 = nn.Linear(d_model, d_model * 4)
        self.linear2 = nn.Linear(d_model * 4, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, tar):
        """src, tar [B, T, d]."""
        src2, _ = self.self_attn(tar, src, src, need_weights=False)
        src = self.norm1(src + src2)
        src2 = self.linear2(torch.relu(self.linear1(src)))
        return self.norm2(src + src2)


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels),
                                nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class SEBasicBlock(nn.Module):
    """conv1 -> ReLU -> bn1 -> conv2 -> bn2 -> SE, plus the shortcut
    (``downsample``: a 1x1 conv and BatchNorm on a stride or a width
    change), then ReLU."""

    def __init__(self, inplanes: int, planes: int, stride=(1, 1),
                 reduction: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = batch_norm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = batch_norm2d(planes)
        self.se = SELayer(planes, reduction)
        if tuple(stride) != (1, 1) or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                batch_norm2d(planes))
        else:
            self.downsample = None

    def forward(self, x):
        out = self.bn1(torch.relu(self.conv1(x)))
        out = self.se(self.bn2(self.conv2(out)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + res)


class AudioEncoder(nn.Module):
    """MFCC [B, 4T, 13] -> [B, T, 128]."""

    def __init__(self, layers=(3, 4, 6, 3), num_filters=(16, 32, 64, 128)):
        super().__init__()
        self.conv1 = nn.Conv2d(1, num_filters[0], 7, stride=(2, 1),
                               padding=3, bias=False)
        self.bn1 = batch_norm2d(num_filters[0])
        inplanes = num_filters[0]
        strides = ((1, 1), (2, 2), (2, 2), (1, 1))
        for li, (blocks, planes, st) in enumerate(
                zip(layers, num_filters, strides), start=1):
            mods = []
            for bi in range(blocks):
                mods.append(SEBasicBlock(inplanes, planes,
                                         st if bi == 0 else (1, 1)))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x):
        x = x.transpose(1, 2)[:, None]  # [B, 1, 13, 4T]
        x = torch.relu(self.bn1(self.conv1(x)))
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=2).transpose(1, 2)  # frequency mean -> [B, T, C]


class ResNetLayer(nn.Module):
    def __init__(self, inplanes: int, outplanes: int, stride: int = 1):
        super().__init__()
        self.conv1a = nn.Conv2d(inplanes, outplanes, 3, stride=stride,
                                padding=1, bias=False)
        self.bn1a = batch_norm2d(outplanes, eps=VISUAL_BN_EPS)
        self.conv2a = nn.Conv2d(outplanes, outplanes, 3, padding=1,
                                bias=False)
        self.downsample = (None if stride == 1 else
                           nn.Conv2d(inplanes, outplanes, 1, stride=stride,
                                     bias=False))
        self.outbna = batch_norm2d(outplanes, eps=VISUAL_BN_EPS)
        self.conv1b = nn.Conv2d(outplanes, outplanes, 3, padding=1,
                                bias=False)
        self.bn1b = batch_norm2d(outplanes, eps=VISUAL_BN_EPS)
        self.conv2b = nn.Conv2d(outplanes, outplanes, 3, padding=1,
                                bias=False)
        self.outbnb = batch_norm2d(outplanes, eps=VISUAL_BN_EPS)

    def forward(self, x):
        b = self.conv2a(torch.relu(self.bn1a(self.conv1a(x))))
        inter = b + (x if self.downsample is None else self.downsample(x))
        b = torch.relu(self.outbna(inter))
        b = self.conv2b(torch.relu(self.bn1b(self.conv1b(b))))
        return torch.relu(self.outbnb(b + inter))


class ResNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.layer1 = ResNetLayer(64, 64, 1)
        self.layer2 = ResNetLayer(64, 128, 2)
        self.layer3 = ResNetLayer(128, 256, 2)
        self.layer4 = ResNetLayer(256, 512, 2)

    def forward(self, x):
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return F.avg_pool2d(x, 4, stride=1)


class VisualFrontend(nn.Module):
    """Normalised frames [B, T, H, W] -> [B, T, 512]."""

    def __init__(self):
        super().__init__()
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False),
            batch_norm3d(64, eps=VISUAL_BN_EPS),
            nn.ReLU(),
            nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1)))
        self.resnet = ResNet()

    def forward(self, x):
        bsz, t, h, w = x.shape
        # the batch and time flattened into the 3-D convolution's depth axis
        v = self.frontend3D(x.reshape(1, 1, bsz * t, h, w))
        v = self.resnet(v[0].transpose(0, 1))  # [B·T, 64, h', w']
        return v.reshape(bsz, t, 512)


class GlobalLayerNorm(nn.Module):
    """Statistics over (C, T) of x [B, C, T]; gamma, beta [1, C, 1]."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        return self.gamma * (x - mean) / torch.sqrt(var + 1e-8) + self.beta


class DSConv1d(nn.Module):
    """x [B, 512, T] -> the block plus x."""

    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(
            nn.ReLU(), batch_norm1d(512),
            nn.Conv1d(512, 512, 3, padding=1, groups=512, bias=False),
            nn.PReLU(), GlobalLayerNorm(512),
            nn.Conv1d(512, 512, 1, bias=False))

    def forward(self, x):
        return self.net(x) + x


class VisualTCN(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(*[DSConv1d() for _ in range(5)])

    def forward(self, x):
        return self.net(x)


class VisualConv1D(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(512, 256, 5, padding=2),
                                 batch_norm1d(256), nn.ReLU(),
                                 nn.Conv1d(256, 128, 1))

    def forward(self, x):
        return self.net(x)


class TalkNetModel(nn.Module):
    """forward(audio_mfcc [B, 4T, 13], faces [B, T, H, W] pixel values) ->
    (scores_av [B, T, 2], scores_a [B, T, 2], scores_v [B, T, 2])."""

    # the Flax submodule names that hold a dot besides an index, the
    # parameters that the JAX package keeps in torch layout
    # (compat/flax_convert.py::flax_from_state_dict)
    flax_joined_names = ("se.fc", "resnet.layer1", "resnet.layer2",
                         "resnet.layer3", "resnet.layer4", "visualTCN.net",
                         "visualConv1D.net")
    flax_raw_names = (
        r".*\.self_attn\.(in_proj_weight|in_proj_bias|out_proj\.weight"
        r"|out_proj\.bias)",
        r"visualTCN\.net\.\d+\.(net\.3\.weight)",
        r"visualTCN\.net\.\d+\.net\.4\.(gamma|beta)")

    def __init__(self):
        super().__init__()
        self.audioEncoder = AudioEncoder()
        self.visualFrontend = VisualFrontend()
        self.visualTCN = VisualTCN()
        self.visualConv1D = VisualConv1D()
        self.crossA2V = AttentionLayer(128, 8)
        self.crossV2A = AttentionLayer(128, 8)
        self.selfAV = AttentionLayer(256, 8)
        self.fcAV = nn.Linear(256, 2)
        self.fcA = nn.Linear(128, 2)
        self.fcV = nn.Linear(128, 2)

    def forward(self, audio, visual):
        a = self.audioEncoder(audio)
        v = self.visualFrontend((visual / 255.0 - 0.4161) / 0.1688)
        v = self.visualConv1D(self.visualTCN(v.transpose(1, 2))).transpose(1, 2)
        a_c = self.crossA2V(a, v)
        v_c = self.crossV2A(v, a)
        av = self.selfAV(torch.cat([a_c, v_c], dim=2),
                         torch.cat([a_c, v_c], dim=2))
        return self.fcAV(av), self.fcA(a_c), self.fcV(v_c)


def talknet_from_flax(variables) -> TalkNetModel:
    """A TalkNetModel (CPU, eval mode) holding the JAX package's Flax
    ``{'params', 'batch_stats'}``."""
    from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax

    model = TalkNetModel()
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    return model.eval()


def flax_variables(model: TalkNetModel) -> dict:
    """The model's weights as the JAX package's Flax ``{'params',
    'batch_stats'}`` (numpy arrays)."""
    from speaker3d_tpu_torch.compat.flax_convert import flax_from_state_dict

    return flax_from_state_dict(model.state_dict(),
                                joined=TalkNetModel.flax_joined_names,
                                raw=TalkNetModel.flax_raw_names)


def load_talknet_exp(exp_dir: str) -> TalkNetModel:
    """The TalkNet of an ASD experiment in the JAX trainer's layout (the
    latest ``models/`` checkpoint's ``asd_state``: Flax ``params`` and
    ``batch_stats``), on the CPU in eval mode."""
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    recovered = Checkpointer(os.path.join(exp_dir, "models")
                             ).recover_if_possible()
    if recovered is None or "asd_state" not in recovered:
        raise FileNotFoundError(f"no TalkNet checkpoint under {exp_dir}/models")
    st = recovered["asd_state"]
    return talknet_from_flax({"params": st["params"],
                              "batch_stats": st["batch_stats"]})
