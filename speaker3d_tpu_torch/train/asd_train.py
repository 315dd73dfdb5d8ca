"""Active speaker detection (TalkNet) training: the train step on one card.

The counterpart of ``speaker3d_tpu/train/asd_train.py``. Per step: TalkNet
in training mode (its BatchNorms update their running statistics as
Flax's, ``models/common.py``) on the MFCC and the face frames, the loss
``CE(AV) + 0.4 CE(A) + 0.4 CE(V)`` against the per-frame labels
(``train/losses.py::entropy_loss``), the scores ``softmax(AV)[..., 1]``,
and Adam written out as the JAX step writes it, with no weight decay:

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with t the step after the increment and the bias corrections in float32
(``train/vad_train.py::make_adam_train_step``, which the VAD, segmenter,
CTC and face detector trainers share), at the per-epoch staircase
``lr * lr_decay ** (step // step_per_epoch)``. The step runs in fp32 (TF32
off).

``state_tree`` / ``load_state_tree`` carry the state as the JAX trainer's
``asd_state`` tree (the Flax ``params``, ``batch_stats``, ``mu``, ``nu``,
``step``; ``vad_train.py``'s, with TalkNet's raw torch-layout leaves), so
either package reads the other's experiments.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from speaker3d_tpu_torch.models.talknet import TalkNetModel
from speaker3d_tpu_torch.train import vad_train
from speaker3d_tpu_torch.train.losses import entropy_loss
from speaker3d_tpu_torch.train.vad_train import AdamTrainState


class ASDTrainConfig(NamedTuple):
    lr: float = 1e-4
    lr_decay: float = 0.95       # per-epoch staircase (reference conf)
    step_per_epoch: int = 1000
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    aux_weight: float = 0.4


def asd_lr(step: int, cfg: ASDTrainConfig) -> torch.Tensor:
    """``lr * lr_decay ** epoch`` of the fp32 ``lr`` and ``lr_decay``, taken
    in float64 and rounded once to a 0-d float32 tensor: within one ulp of
    the JAX step's fp32 ``power`` (XLA's is itself up to an ulp off)."""
    epoch = step // cfg.step_per_epoch
    lr = float(np.float32(cfg.lr)) * float(np.float32(cfg.lr_decay)) ** epoch
    return torch.tensor(lr, dtype=torch.float32)


def init_talknet(seed: int) -> TalkNetModel:
    """TalkNet with Flax's initialisation, drawn from a torch generator
    seeded with ``seed``: lecun-normal convolutions and Dense layers
    (``models/fsmn_vad.py::lecun_init_``), xavier-uniform attention
    projections (``in_proj_weight`` [3d, d] and ``out_proj.weight``: fan-in
    plus fan-out 4d and 2d, as Flax's and torch's), zero biases, unit
    norms, the PReLU at 0.25."""
    from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_

    gen = torch.Generator().manual_seed(seed)
    model = lecun_init_(TalkNetModel(), gen)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.MultiheadAttention):
                for w in (module.in_proj_weight, module.out_proj.weight):
                    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                    w.uniform_(-limit, limit, generator=gen)
                module.in_proj_bias.zero_()
                module.out_proj.bias.zero_()
    return model


def make_asd_train_step(cfg: ASDTrainConfig) -> Callable:
    """``step(state, batch) -> {'loss', 'lr', 'scores' [B, T]}``: one step
    on ``state`` (``train/vad_train.py::init_adam_train_state`` of a
    TalkNet) in place. ``batch``: ``{'audio' [B, 4T, 13], 'visual' [B,
    T, 112, 112] float32, 'labels' [B, T] int}`` on the state's device."""

    def loss_fn(outputs, batch):
        av, a, v = outputs
        labels = batch["labels"].long()
        loss = (entropy_loss(av, labels)
                + cfg.aux_weight * entropy_loss(a, labels)
                + cfg.aux_weight * entropy_loss(v, labels))
        return loss, torch.softmax(av.detach(), dim=-1)[..., 1]

    return vad_train.make_adam_train_step(
        loss_fn, cfg, input_key=("audio", "visual"),
        lr_fn=lambda step: asd_lr(step, cfg), aux_key="scores")


# the JAX ASD trainer's names of Adam's moments in its ``asd_state``
MOMENTS = ("mu", "nu")


def state_tree(state: AdamTrainState) -> Dict:
    """The JAX trainer's ``asd_state`` tree of ``state`` (numpy arrays)."""
    return vad_train.state_tree(state, MOMENTS)


def load_state_tree(state: AdamTrainState, tree: Dict) -> None:
    """Load an ``asd_state`` tree of either package's trainer into
    ``state``."""
    vad_train.load_state_tree(state, tree, MOMENTS)
