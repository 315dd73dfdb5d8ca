"""Segmentation training: the train step on one card (Adam + PIT BCE).

The counterpart of ``speaker3d_tpu/train/seg_train.py``: the step of
``train/vad_train.py`` (fbank, LR schedule, Adam with L2, fp32, the same
state and checkpoint tree) with the permutation-invariant frame BCE over
[B, T, K] activations and the permutation-aligned frame accuracy.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from speaker3d_tpu_torch.models.segmentation import pit_bce
from speaker3d_tpu_torch.train.vad_train import (
    VadTrainConfig, make_adam_train_step)

SegTrainConfig = VadTrainConfig


def seg_loss(logits, batch):
    """(PIT BCE summed over the batch / B; the frame accuracy against the
    labels in the order the PIT chose, likewise)."""
    labels = batch["labels"].to(torch.float32)
    b = logits.shape[0]
    per_ex, assignment = pit_bce(logits, labels)
    loss = per_ex.sum() / b
    with torch.no_grad():
        aligned = torch.gather(labels, 2, assignment[:, None, :].expand(
            -1, labels.shape[1], -1))
        acc = ((logits > 0) == (aligned > 0.5)).to(torch.float32).mean(
            dim=(1, 2)).sum() / b
    return loss, acc


def make_seg_train_step(cfg: SegTrainConfig,
                        feature_fn: Optional[Callable] = None) -> Callable:
    """Batches: ``{'wavs' | 'feats', 'labels': [B, T, K] per-frame
    per-channel activity targets}``."""
    return make_adam_train_step(seg_loss, cfg, feature_fn)
