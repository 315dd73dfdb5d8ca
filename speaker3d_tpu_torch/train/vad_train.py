"""VAD training: the train step on one card (Adam + frame BCE).

The counterpart of ``speaker3d_tpu/train/vad_train.py``. Per step: the Kaldi
fbank with no mean-norm (``feature_fn``; on a card the fbank kernel, whose
input, the waveform, needs no gradient), the LR schedule at the step
counter, the model, the stable BCE with logits averaged over frames and
summed over the batch / B, the JAX trainer's frame accuracy, and Adam with
L2 added to the gradient, written out as the JAX step writes it:

    g += wd * p;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with t the step after the increment and the bias corrections in float32
(``torch.optim.Adam`` puts eps after its own bias correction of sqrt(v) and
decays otherwise). The step runs in fp32 (TF32 off).

The state holds the model, the Adam moments by parameter name and the step;
``state_tree`` / ``load_state_tree`` carry it as the JAX trainer's
checkpoint tree (the Flax ``params``, ``adam_m``, ``adam_v``, ``step``), so
either package reads the other's experiments. ``seg_train.py`` shares all
of it but the loss.
"""

from __future__ import annotations

from typing import (Callable, Dict, NamedTuple, Optional, Sequence,
                    Union)

import numpy as np
import torch

from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.models.segmentation import bce_with_logits
from speaker3d_tpu_torch.train.schedulers import warmup_cosine_lr


class VadTrainConfig(NamedTuple):
    min_lr: float = 1e-5
    max_lr: float = 1e-3
    warmup_epoch: int = 1
    fix_epoch: int = 10
    step_per_epoch: int = 1000
    weight_decay: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


class AdamTrainState:
    """The model, Adam's first and second moments by parameter name, the
    step."""

    def __init__(self, model: torch.nn.Module, adam_m: Dict, adam_v: Dict,
                 step: int = 0):
        self.model = model
        self.adam_m = adam_m
        self.adam_v = adam_v
        self.step = step


def init_adam_train_state(model: torch.nn.Module,
                          device=DEFAULT_DEVICE) -> AdamTrainState:
    """``model`` (already initialised) moved to ``device``, zero moments,
    step 0."""
    model.to(resolve_device(device))
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return AdamTrainState(model, zeros,
                          {n: torch.zeros_like(p) for n, p in zeros.items()})


def make_adam_train_step(loss_fn: Callable, cfg, feature_fn:
                         Optional[Callable] = None,
                         input_key: Union[str, Sequence[str], None] = None,
                         lr_fn: Optional[Callable] = None,
                         aux_key: str = "acc") -> Callable:
    """``step(state, batch) -> {'loss'[, aux_key], 'lr'}``: one Adam step on
    ``state`` in place. ``loss_fn(outputs, batch) -> (loss, aux or None)``
    reads its targets from the batch (``labels``, and for CTC
    ``label_lens``); ``aux`` (the frame accuracy, TalkNet's scores) is
    returned under ``aux_key``.

    ``batch``: ``{'wavs': [B, L] float32, 'labels', ...}`` on the state's
    device when ``feature_fn`` is given, else ``{'feats': [B, T, F],
    'labels', ...}``; ``input_key`` names another model input (the face
    detector's ``frames``), or a tuple of inputs (TalkNet's ``audio``,
    ``visual``). ``cfg``: ``beta1``, ``beta2``, ``eps``, and
    ``weight_decay`` (none added when it is 0 or absent); the lr is
    ``lr_fn(step)``, by default ``cfg``'s ``warmup_cosine_lr``. ``loss`` and
    ``aux`` are tensors on the device (no host sync), ``lr`` a 0-d float32
    CPU tensor."""
    batch_key = input_key or ("wavs" if feature_fn is not None else "feats")
    keys = (batch_key,) if isinstance(batch_key, str) else tuple(batch_key)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    wd = getattr(cfg, "weight_decay", 0.0)
    if lr_fn is None:
        def lr_fn(step):
            return warmup_cosine_lr(
                step, min_lr=cfg.min_lr, max_lr=cfg.max_lr,
                warmup_epoch=cfg.warmup_epoch, fix_epoch=cfg.fix_epoch,
                step_per_epoch=cfg.step_per_epoch)

    def step(state: AdamTrainState, batch) -> Dict[str, torch.Tensor]:
        lr = lr_fn(state.step)
        # the bias corrections of step t, in float32 as the JAX step's
        t = np.float32(state.step + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        with matmul_precision("float32"):
            xs = [batch[k] for k in keys]
            if feature_fn is not None:
                xs = [feature_fn(x) for x in xs]
            state.model.train()
            names, params = zip(*state.model.named_parameters())
            loss, aux = loss_fn(state.model(*xs), batch)
            params = list(params)
            grads = list(torch.autograd.grad(loss, params))
            with torch.no_grad():
                m = [state.adam_m[n] for n in names]
                v = [state.adam_v[n] for n in names]
                g = (torch._foreach_add(grads, params, alpha=wd) if wd
                     else grads)
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, g, alpha=1 - b1)
                torch._foreach_mul_(v, b2)
                torch._foreach_addcmul_(v, g, g, value=1 - b2)
                denom = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                upd = torch._foreach_div(m, bc1)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(params, upd, alpha=-float(lr))
        state.step += 1
        metrics = {"loss": loss.detach(), "lr": lr}
        if aux is not None:
            metrics[aux_key] = aux
        return metrics

    return step


def vad_loss(logits, batch):
    """(mean over frames, summed over the batch / B, of the frame BCE; the
    frame accuracy likewise)."""
    labels = batch["labels"].to(torch.float32)
    b = logits.shape[0]
    loss = bce_with_logits(logits, labels).mean(dim=-1).sum() / b
    with torch.no_grad():
        acc = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean(
            dim=-1).sum() / b
    return loss, acc


def make_vad_train_step(cfg: VadTrainConfig,
                        feature_fn: Optional[Callable] = None) -> Callable:
    """Batches: ``{'wavs' | 'feats', 'labels': [B, T] per-frame speech
    targets}``."""
    return make_adam_train_step(vad_loss, cfg, feature_fn)


def state_tree(state: AdamTrainState,
               moments: Sequence[str] = ("adam_m", "adam_v")) -> Dict:
    """The JAX trainer's checkpoint tree of ``state`` (numpy arrays): the
    Flax ``params``, the ``batch_stats`` of a model with BatchNorms (the
    face detector, TalkNet), the two moments under the names ``moments``
    (the JAX ASD trainer's are ``mu``, ``nu``), ``step``; a model's
    ``flax_joined_names`` are its dotted Flax names and its
    ``flax_raw_names`` its leaves in torch layout
    (``compat/flax_convert.py``)."""
    joined = getattr(state.model, "flax_joined_names", ())
    raw = getattr(state.model, "flax_raw_names", ())

    def tree(sd):
        return flax_from_state_dict(sd, joined, raw=raw)["params"]

    model = flax_from_state_dict(state.model.state_dict(), joined, raw=raw)
    out = {"params": model["params"]}
    if model.get("batch_stats"):
        out["batch_stats"] = model["batch_stats"]
    return {**out, moments[0]: tree(state.adam_m),
            moments[1]: tree(state.adam_v),
            "step": np.asarray(state.step, np.int32)}


def load_state_tree(state: AdamTrainState, tree: Dict,
                    moments: Sequence[str] = ("adam_m", "adam_v")) -> None:
    """Load a checkpoint tree of either package's trainer into ``state``
    (the moments under the names ``moments``)."""
    like = state.model.state_dict()
    state.model.load_state_dict(
        state_dict_from_flax({"params": tree["params"],
                              "batch_stats": tree.get("batch_stats", {})},
                             like=like), strict=True)
    with torch.no_grad():
        for key, bufs in zip(moments, (state.adam_m, state.adam_v)):
            sd = state_dict_from_flax({"params": tree[key]}, like=like)
            if sorted(sd) != sorted(bufs):
                raise KeyError(f"{key} does not match the model's parameters")
            for name, buf in bufs.items():
                buf.copy_(sd[name])
    state.step = int(np.asarray(tree["step"]))
