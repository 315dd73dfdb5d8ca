"""Supervised SV training: the train step on one card.

The counterpart of ``speaker3d_tpu/train/sv_train.py``. Per step: PCM16
decode on the card, Kaldi fbank with mean-norm (``feature_fn``; on a card
the fbank kernel), the backbone in training mode, the cosine classifier, the
AAM loss as the mean cross entropy, the JAX trainer's accuracy (the target
cosine at least the row max minus 1e-7), and SGD with Nesterov momentum and
weight decay on every parameter (BatchNorm and biases included):

    g += wd * p;  buf = m * buf + g;  p -= lr * (g + m * buf)   (nesterov)

which is ``torch.optim.SGD(momentum=m, nesterov=True, weight_decay=wd)``'s
update, with the buffers kept by parameter name for the checkpoint. lr and
margin come from the step counter before it is incremented. TF32 is off for
the step's duration and restored afterwards.

``compute_dtype: bfloat16`` runs the backbone in bf16 as the JAX step does:
the fbank in fp32, then the features and a bf16 cast of every fp32
parameter into the backbone (``bf16_parameters``; the BatchNorm running
statistics stay fp32 buffers, and BatchNorm normalises as Flax's under
``bn_compute_dtype(bfloat16)``, ``models/common.py``), the embedding cast
back to fp32; the classifier, the loss, the accuracy and SGD run in fp32
on the fp32 masters, whose gradients are the bf16 gradients cast up (the
backward of the cast). Not ``torch.autocast``, which keeps BatchNorm and
reductions in fp32 and casts per op: a different computation.

One card: ``model_parallel > 1`` (classes sharded over cards) is ROADMAP.md
M14. ``remat`` recomputes activations in the backward instead of keeping
them, as the JAX step chooses: a model with a ``remat`` field (ERes2NetV2,
ERes2Net) recomputes each residual block, else one with a
``memory_efficient`` field (CAM++) each dense layer, and every other
backbone (ResNet, Res2Net, ECAPA-TDNN, x-vector) the whole backbone
forward (``models/common.py::checkpointed``). No recomputation updates the
BatchNorm running statistics a second time, and in a bf16 step it reads
the same bf16 casts of the parameters.

The train state's checkpoint tree (``state_tree``) holds ``model/<state_dict
name>``, ``cls_w``, ``momentum/model/<parameter name>``, ``momentum/cls_w``
and ``step``; ``flax_state_tree`` writes the JAX trainer's tree
(``params/...``, ``batch_stats/...``), which ``load_state_tree`` also
reads, through ``state_dict_from_flax``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.models.common import checkpointed
from speaker3d_tpu_torch.train.losses import sharded_arc_margin_loss
from speaker3d_tpu_torch.train.schedulers import margin_at_step, warmup_cosine_lr

MODEL_PARALLEL_NOT_PORTED = ("model_parallel > 1 (classes sharded over "
                             "several cards) is ROADMAP.md M14; one card "
                             "holds the whole classifier")


class SVTrainConfig(NamedTuple):
    num_classes: int
    embedding_size: int = 192
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-4
    min_lr: float = 1e-4
    max_lr: float = 0.2
    warmup_epoch: int = 5
    fix_epoch: int = 70
    step_per_epoch: int = 1000
    initial_margin: float = 0.0
    final_margin: float = 0.3
    increase_start_epoch: int = 20
    margin_fix_epoch: int = 50
    increase_type: str = "exp"
    scale: float = 32.0
    easy_margin: bool = False
    remat: bool = False
    compute_dtype: str = "float32"  # or "bfloat16" (the backbone's dtype)


class SVTrainState:
    """The backbone (its parameters and BatchNorm statistics), the
    classifier weight, the SGD buffers by parameter name, the step."""

    def __init__(self, model: torch.nn.Module, cls_w: torch.Tensor,
                 momentum: Dict, step: int = 0):
        self.model = model
        self.cls_w = cls_w
        self.momentum = momentum
        self.step = step


def check_train_options(model, cfg: SVTrainConfig,
                        model_parallel: int = 1) -> None:
    """Refuse what the port does not run yet, naming its ROADMAP.md item."""
    if model_parallel != 1:
        raise NotImplementedError(MODEL_PARALLEL_NOT_PORTED)
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; "
                         f"expected 'float32' or 'bfloat16'")


def enable_remat(model: torch.nn.Module) -> bool:
    """The JAX step's choice of recomputation: sets the model's ``remat``
    field, else its ``memory_efficient`` field, to True and returns False;
    returns True for a model with neither, whose whole forward the step then
    recomputes."""
    for field in ("remat", "memory_efficient"):
        if hasattr(model, field):
            setattr(model, field, True)
            return False
    return True


def init_sv_train_state(model: torch.nn.Module, cfg: SVTrainConfig, *,
                        seed: int = 0, device=DEFAULT_DEVICE,
                        cls_w: Optional[torch.Tensor] = None) -> SVTrainState:
    """The model moved to ``device``, a classifier weight (Xavier uniform
    over [num_classes, embedding_size], drawn from a ``torch.Generator``
    seeded with ``seed + 1``, unless given), zero SGD buffers, step 0."""
    dev = resolve_device(device)
    model.to(dev)
    if cls_w is None:
        limit = math.sqrt(6.0 / (cfg.num_classes + cfg.embedding_size))
        gen = torch.Generator().manual_seed(seed + 1)
        cls_w = (torch.rand((cfg.num_classes, cfg.embedding_size),
                            generator=gen) * 2 - 1) * limit
    cls_w = torch.tensor(np.asarray(cls_w), dtype=torch.float32, device=dev) \
        if not isinstance(cls_w, torch.Tensor) else cls_w.detach().to(dev)
    cls_w.requires_grad_(True)
    momentum = {"model": {n: torch.zeros_like(p)
                          for n, p in model.named_parameters()},
                "cls_w": torch.zeros_like(cls_w)}
    return SVTrainState(model, cls_w, momentum, 0)


@contextlib.contextmanager
def bf16_parameters(model: torch.nn.Module):
    """Within the block every fp32 parameter of ``model`` reads as its bf16
    cast (a tensor in autograd's graph, so gradients reach the fp32
    masters); buffers stay as they are. The block spans the backward too: a
    checkpointed block's recomputation reads the same casts."""
    masters = [(mod, name, p) for mod in model.modules()
               for name, p in mod._parameters.items()
               if p is not None and p.dtype == torch.float32]
    try:
        for mod, name, p in masters:
            mod._parameters[name] = p.to(torch.bfloat16)
        yield
    finally:
        for mod, name, p in masters:
            mod._parameters[name] = p


def _l2norm(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def make_sv_train_step(model: torch.nn.Module, cfg: SVTrainConfig,
                       feature_fn: Optional[Callable] = None,
                       model_parallel: int = 1) -> Callable:
    """``step(state, batch) -> metrics``: one SGD step on ``state`` in place.

    ``batch``: ``{'wavs': [B, L] float32 or int16 PCM, 'labels': [B]}`` on
    the state's device when ``feature_fn`` (e.g. ``KaldiFbank(mean_norm=
    True)``) is given, else ``{'feats': [B, T, F], 'labels'}``. ``metrics``:
    ``loss`` and ``acc`` as 0-d tensors on the device (no host sync), ``lr``
    and ``margin`` as 0-d float32 CPU tensors."""
    check_train_options(model, cfg, model_parallel)
    remat_whole = cfg.remat and enable_remat(model)
    batch_key = "wavs" if feature_fn is not None else "feats"
    m, wd = cfg.momentum, cfg.weight_decay
    half = cfg.compute_dtype == "bfloat16"

    def step(state: SVTrainState, batch) -> Dict[str, torch.Tensor]:
        lr = warmup_cosine_lr(
            state.step, min_lr=cfg.min_lr, max_lr=cfg.max_lr,
            warmup_epoch=cfg.warmup_epoch, fix_epoch=cfg.fix_epoch,
            step_per_epoch=cfg.step_per_epoch)
        margin = margin_at_step(
            state.step, increase_start_epoch=cfg.increase_start_epoch,
            fix_epoch=cfg.margin_fix_epoch, step_per_epoch=cfg.step_per_epoch,
            initial_margin=cfg.initial_margin, final_margin=cfg.final_margin,
            increase_type=cfg.increase_type)
        with matmul_precision("float32"):
            x, labels = batch[batch_key], batch["labels"].long()
            if x.dtype == torch.int16:
                # the int16 wire: k/32768, exact on the card
                x = x.to(torch.float32) * (1.0 / 32768.0)
            if feature_fn is not None:
                # fbank (on a card, the fbank kernel) with autograd on: its
                # input, the waveform, needs no gradient, so the kernel
                # needs no backward and no autograd.Function
                x = feature_fn(x)
            state.model.train()
            names, params = zip(*state.model.named_parameters())
            with (bf16_parameters(state.model) if half
                  else contextlib.nullcontext()):
                x = x.to(torch.bfloat16) if half else x
                emb = (checkpointed(state.model, x) if remat_whole
                       else state.model(x))
                # the classifier's dtype: fp32 after a bf16 backbone
                cls_w = state.cls_w
                cos = _l2norm(emb.to(cls_w.dtype)) @ _l2norm(cls_w).T
                ce = sharded_arc_margin_loss(cos, labels, 0, float(margin),
                                             cfg.scale, cfg.easy_margin)
                b = cos.shape[0]
                loss = ce.sum() / b
                grads = torch.autograd.grad(loss,
                                            list(params) + [state.cls_w])
            with torch.no_grad():
                top = cos.max(dim=-1).values
                tgt = cos.gather(1, labels[:, None])[:, 0]
                acc = (tgt >= top - 1e-7).to(torch.float32).sum() / b
                leaves = list(params) + [state.cls_w]
                bufs = ([state.momentum["model"][n] for n in names]
                        + [state.momentum["cls_w"]])
                g = torch._foreach_add(grads, leaves, alpha=wd)
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, g)
                d = torch._foreach_add(g, bufs, alpha=m) if cfg.nesterov \
                    else bufs
                torch._foreach_add_(leaves, d, alpha=-float(lr))
        state.step += 1
        return {"loss": loss.detach(), "acc": acc, "lr": lr, "margin": margin}

    return step


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_tree(state: SVTrainState) -> Dict:
    """The checkpoint tree of ``state`` (numpy arrays)."""
    return {"model": {k: _numpy(v)
                      for k, v in state.model.state_dict().items()},
            "cls_w": _numpy(state.cls_w),
            "momentum": {"model": {k: _numpy(v) for k, v in
                                   state.momentum["model"].items()},
                         "cls_w": _numpy(state.momentum["cls_w"])},
            "step": np.asarray(state.step, np.int32)}


def flax_state_tree(state: SVTrainState) -> Dict:
    """The checkpoint tree of ``state`` in the JAX trainer's layout
    (``params``, ``batch_stats``, ``cls_w``, ``momentum/params``,
    ``momentum/cls_w``, ``step``), which either package's trainer resumes."""
    model = state.model
    names = (getattr(model, "flax_joined_names", ()),
             getattr(model, "flax_dense_names", ()))
    variables = flax_from_state_dict(model.state_dict(), *names)
    moments = flax_from_state_dict(state.momentum["model"], *names)
    return {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "cls_w": _numpy(state.cls_w),
            "momentum": {"params": moments["params"],
                         "cls_w": _numpy(state.momentum["cls_w"])},
            "step": np.asarray(state.step, np.int32)}


def model_state_dict_from_tree(tree: Dict, like: Dict) -> Dict:
    """The backbone's state_dict from a checkpoint tree of either trainer:
    this package's (``model/...``) or the JAX package's (``params/...``,
    ``batch_stats/...``)."""
    if "model" in tree:
        return {k: torch.as_tensor(np.asarray(v)) for k, v in
                tree["model"].items()}
    if "params" in tree:
        return state_dict_from_flax(
            {"params": tree["params"],
             "batch_stats": tree.get("batch_stats", {})}, like=like)
    raise KeyError("checkpoint tree holds neither 'model' nor 'params'")


def _check_shape(key: str, got, want) -> None:
    if tuple(np.shape(got)) != tuple(want.shape):
        raise ValueError(f"'{key}' shape {tuple(np.shape(got))} differs from "
                         f"this config's {tuple(want.shape)} (e.g. a "
                         f"different class count)")


def load_state_tree(state: SVTrainState, tree: Dict, *,
                    optimizer: bool = True) -> None:
    """Load a checkpoint tree of either trainer into ``state``: the model
    (``strict=True``) and ``cls_w``, and with ``optimizer`` the SGD buffers
    and the step (a warm start leaves them reset)."""
    model = state.model
    like = model.state_dict()
    sd = model_state_dict_from_tree(tree, like)
    for k, v in sd.items():
        if k in like:
            _check_shape(k, v, like[k])
    model.load_state_dict(sd, strict=True)
    _check_shape("cls_w", tree["cls_w"], state.cls_w)
    with torch.no_grad():
        state.cls_w.copy_(torch.as_tensor(np.asarray(tree["cls_w"])))
    if not optimizer:
        return
    mom = tree["momentum"]
    if "model" in mom:
        bufs = {k: np.asarray(v) for k, v in mom["model"].items()}
    else:
        bufs = state_dict_from_flax({"params": mom["params"]}, like=like)
    if sorted(bufs) != sorted(state.momentum["model"]):
        raise KeyError("momentum buffers do not match the model's parameters")
    with torch.no_grad():
        for k, buf in state.momentum["model"].items():
            buf.copy_(torch.as_tensor(np.asarray(bufs[k])))
        state.momentum["cls_w"].copy_(torch.as_tensor(np.asarray(mom["cls_w"])))
    state.step = int(np.asarray(tree["step"]))
