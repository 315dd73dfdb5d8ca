"""Tiny anchor-free face detector (centre heatmap + size regression).

The counterpart of ``speaker3d_tpu/models/face_detector.py``: three stride-2
conv + BatchNorm + ReLU stages (a stride-8 map), a 3x3 neck, then two 3x3
heads, a face-centre heatmap (focal BCE against gaussian targets) and a
size map ((w, h) in pixels, L1 at the centres, ``softplus * STRIDE``).
``cli/train_face_detector.py`` trains it on rendered faces
(``data/synthetic_faces.py``) or on annotated frames.

Flax's ``padding="SAME"`` pads the low side by total // 2: at stride 2 on
an even size that is (0, 1), where torch's ``padding=1`` would pad (1, 1)
and shift every output by a pixel, so the stride-2 convolutions pad
explicitly from each dimension's size (``same_pad``).

The targets (``gaussian_heatmap``) and the decoder (``decode_detections``,
3x3 local maxima above a threshold, float64) are host numpy, as in the
JAX package; ``load_face_detector_exp`` runs the forward on ``device`` at
batch 1 and decodes on the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.models.common import batch_norm2d

STRIDE = 8


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one dimension: (low, high), low =
    total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class TinyFaceDetector(nn.Module):
    """Module names as the JAX package's Flax submodules: ``conv{i}``,
    ``bn{i}``, ``neck``, ``heat``, ``size``."""

    def __init__(self, channels: int = 24):
        super().__init__()
        c = channels
        widths = (1, c, 2 * c, 4 * c)
        for i in range(3):
            setattr(self, f"conv{i}", nn.Conv2d(widths[i], widths[i + 1], 3,
                                                stride=2, bias=False))
            setattr(self, f"bn{i}", batch_norm2d(widths[i + 1]))
        self.neck = nn.Conv2d(4 * c, 4 * c, 3, padding=1)
        self.heat = nn.Conv2d(4 * c, 1, 3, padding=1)
        self.size = nn.Conv2d(4 * c, 2, 3, padding=1)

    def forward(self, x):
        """x [B, H, W, 1] float32 in [0, 1] (the JAX batch layout); H, W
        multiples of 8. -> (heat_logits [B, H/8, W/8], sizes [B, H/8, W/8,
        2] in pixels)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            h, w = x.shape[-2:]
            x = F.pad(x, same_pad(w, 3, 2) + same_pad(h, 3, 2))
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        x = torch.relu(self.neck(x))
        heat = self.heat(x)[:, 0]
        # sizes regressed in STRIDE units (typical faces are 3-8 strides
        # wide, a scale the head reaches quickly from init)
        size = F.softplus(self.size(x)) * float(STRIDE)
        return heat, size.permute(0, 2, 3, 1)


def gaussian_heatmap(h: int, w: int, boxes, stride: int = STRIDE,
                     sigma_frac: float = 0.25
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Targets for one frame: boxes [(x, y, w, h)] in pixels ->
    (heat [h/s, w/s], size [h/s, w/s, 2], mask [h/s, w/s])."""
    gh, gw = h // stride, w // stride
    heat = np.zeros((gh, gw), np.float32)
    size = np.zeros((gh, gw, 2), np.float32)
    mask = np.zeros((gh, gw), np.float32)
    ys, xs = np.mgrid[0:gh, 0:gw]
    for (x, y, bw, bh) in boxes:
        # gaussian centred at the ROUNDED cell (CenterNet convention), so
        # the heatmap's peak is exactly 1.0 at the cell that carries the size
        iy = int(round((y + bh / 2) / stride - 0.5))
        ix = int(round((x + bw / 2) / stride - 0.5))
        if not (0 <= iy < gh and 0 <= ix < gw):
            continue
        sigma = max(sigma_frac * max(bw, bh) / stride, 0.5)
        g = np.exp(-((xs - ix) ** 2 + (ys - iy) ** 2) / (2 * sigma ** 2))
        heat = np.maximum(heat, g.astype(np.float32))
        size[iy, ix] = (bw, bh)
        mask[iy, ix] = 1.0
    return heat, size, mask


def detector_loss(heat_logits, sizes, target_heat, target_size, target_mask,
                  *, focal_gamma: float = 2.0, size_weight: float = 0.5):
    """Focal BCE on the heatmap + masked L1 on the sizes (per-batch mean)
    -> (loss, heat_loss, size_loss), 0-d tensors."""
    p = 1.0 / (1.0 + torch.exp(-heat_logits))
    pos = (target_heat > 0.99).to(p.dtype)
    # CenterNet's penalty-reduced focal loss
    pos_loss = -pos * ((1 - p) ** focal_gamma) * torch.log(
        torch.clamp(p, min=1e-6))
    neg_loss = -(1 - pos) * ((1 - target_heat) ** 4) * (
        p ** focal_gamma) * torch.log(torch.clamp(1 - p, min=1e-6))
    n_pos = torch.clamp(pos.sum(), min=1.0)
    heat_loss = (pos_loss.sum() + neg_loss.sum()) / n_pos
    # L1 in stride units, so the size term starts at the focal term's order
    size_loss = (target_mask[..., None]
                 * torch.abs(sizes - target_size)).sum() / n_pos / STRIDE
    return heat_loss + size_weight * size_loss, heat_loss, size_loss


def decode_detections(heat_logits: np.ndarray, sizes: np.ndarray,
                      *, threshold: float = 0.35, max_det: int = 8,
                      stride: int = STRIDE
                      ) -> List[Tuple[float, float, float, float]]:
    """One frame's (heat [gh, gw], size [gh, gw, 2]) -> [(x, y, w, h)]:
    3x3 local maxima above ``threshold``, highest score first."""
    p = 1.0 / (1.0 + np.exp(-np.asarray(heat_logits, np.float64)))
    gh, gw = p.shape
    pad = np.pad(p, 1, constant_values=-1.0)
    windows = np.stack([pad[dy:dy + gh, dx:dx + gw]
                        for dy in range(3) for dx in range(3)])
    is_max = p >= windows.max(axis=0) - 1e-12
    cand = np.argwhere(is_max & (p >= threshold))
    scored = sorted(((p[iy, ix], iy, ix) for iy, ix in cand), reverse=True)
    out = []
    for score, iy, ix in scored[:max_det]:
        bw, bh = np.asarray(sizes)[iy, ix]
        cx, cy = (ix + 0.5) * stride, (iy + 0.5) * stride
        out.append((float(cx - bw / 2), float(cy - bh / 2),
                    float(bw), float(bh)))
    return out


def load_face_detector(exp_dir: str) -> TinyFaceDetector:
    """The detector of a ``cli/train_face_detector.py`` experiment of
    either package (``config.yaml``'s ``model.args``; the latest
    ``models/`` checkpoint's ``train_state``: Flax ``params`` and
    ``batch_stats``), on the CPU in eval mode."""
    from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.config import build_config

    config = build_config(os.path.join(exp_dir, "config.yaml"))
    model = TinyFaceDetector(**config.get("model", {}).get("args", {}))
    states = Checkpointer(os.path.join(exp_dir, "models")).recover_if_possible()
    if states is None or "train_state" not in states:
        raise FileNotFoundError(f"no checkpoint under {exp_dir}/models")
    ts = states["train_state"]
    model.load_state_dict(state_dict_from_flax(
        {"params": ts["params"], "batch_stats": ts["batch_stats"]},
        like=model.state_dict()), strict=True)
    return model.eval()


def make_detector(model: TinyFaceDetector, threshold: float = 0.35,
                  device=DEFAULT_DEVICE):
    """``detector(frame [H, W] uint8) -> [(x, y, w, h)]``: the frame scaled
    to [0, 1] and zero-padded to multiples of 8, the forward at batch 1 on
    ``device`` in fp32 (TF32 off), the decoding on the host."""
    from speaker3d_tpu_torch.eval.embedding import matmul_precision

    dev = resolve_device(device)
    model.to(dev).eval()

    def detector(frame: np.ndarray):
        h, w = frame.shape[:2]
        ph = -(-h // STRIDE) * STRIDE
        pw = -(-w // STRIDE) * STRIDE
        x = np.zeros((1, ph, pw, 1), np.float32)
        x[0, :h, :w, 0] = frame.astype(np.float32) / 255.0
        with torch.inference_mode(), matmul_precision("float32", dev):
            heat, size = model(torch.from_numpy(x).to(dev))
        return decode_detections(heat[0].cpu().numpy(), size[0].cpu().numpy(),
                                 threshold=threshold)

    return detector


def load_face_detector_exp(exp_dir: str, threshold: float = 0.35,
                           device=DEFAULT_DEVICE):
    """A ``cli/train_face_detector.py`` experiment -> ``detector(frame) ->
    boxes`` for ``diar/video.py::build_face_tracks``, on ``device``."""
    dev = resolve_device(device)
    return make_detector(load_face_detector(exp_dir), threshold, dev)
