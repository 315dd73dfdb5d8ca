"""Supervised SV training: the train step, on one card or a mesh of them.

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

On a ``('data', 'model')`` mesh (``parallel/mesh.py``; one process per
card) the step is the JAX step's arithmetic: each rank takes its data
row's share of the global batch (the model axis's ranks the rows of their
row's model rank 0), the backbone and its BatchNorm statistics are
replicated, the classifier's classes, padded to a multiple of the model
axis (``_padded_classes``; the padded columns masked to cosine -1), are
sharded over ``model``, and the AAM loss reduces across the class shards
(``train/losses.py::sharded_arc_margin_loss``). The loss is ``sum(ce) /
(global_b * n_model)``: every model rank holds the same value, and the
backward of the loss's psum sums the cotangents. Backbone gradients are
summed over the whole mesh, the classifier's over ``data``; the loss over
the whole mesh, the accuracy over ``data``; the BatchNorm running
statistics are averaged over the whole mesh after the step. Without a mesh
the step is the one-card step, which a world-1 mesh computes exactly.
``remat`` recomputes activations in the backward instead of keeping
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
reads, through ``state_dict_from_flax``. On a mesh both gather ``cls_w``
and its buffer (every rank calls them; rank 0 writes), and
``load_state_tree`` reads a tree of any mesh shape: the first
``num_classes`` rows are the classes, padded rows are dropped or added as
zeros.
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
from speaker3d_tpu_torch.parallel.mesh import (
    AXES, Mesh, all_gather, all_reduce_, model_sharded, pmax, replicated,
    shard)
from speaker3d_tpu_torch.train.losses import sharded_arc_margin_loss
from speaker3d_tpu_torch.train.schedulers import margin_at_step, warmup_cosine_lr


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
    classifier weight (on a mesh this rank's class shard), the SGD buffers
    by parameter name, the step, the class count and the mesh (None: one
    process)."""

    def __init__(self, model: torch.nn.Module, cls_w: torch.Tensor,
                 momentum: Dict, step: int = 0, *,
                 num_classes: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.cls_w = cls_w
        self.momentum = momentum
        self.step = step
        self.num_classes = num_classes
        self.mesh = mesh


def _n_model(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape["model"]


def _padded_classes(num_classes: int, n_model: int) -> int:
    return -(-num_classes // n_model) * n_model


def state_specs(state: SVTrainState) -> Dict:
    """The placement spec of each leaf of ``state_tree(state)``: ``cls_w``
    and its SGD buffer split over ``model``, the rest replicated."""
    rep_ = {k: () for k in state.model.state_dict()}
    cls = ("model", None)
    return {"model": rep_, "cls_w": cls,
            "momentum": {"model": {k: () for k in state.momentum["model"]},
                         "cls_w": cls},
            "step": ()}


def state_shardings(state: SVTrainState, mesh: Mesh) -> Dict:
    """``state_specs`` as placements on ``mesh``."""
    def place(spec):
        if isinstance(spec, dict):
            return {k: place(v) for k, v in spec.items()}
        return model_sharded(mesh) if spec else replicated(mesh)
    return place(state_specs(state))


def check_train_options(model, cfg: SVTrainConfig) -> None:
    """Refuse a compute dtype the step does not know."""
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


def _class_rows(w, num_classes: int, c_pad: int, what: str) -> torch.Tensor:
    """A global classifier array of any mesh's padding as ``c_pad`` rows:
    its first ``num_classes`` rows are the classes; padded rows beyond
    ``c_pad`` are dropped, missing ones added as zeros (masked in the
    step). A mesh pads fewer rows than its model axis, which is at most the
    class count, so ``num_classes`` or more extra rows are another class
    count."""
    w = w.detach() if isinstance(w, torch.Tensor) else torch.as_tensor(
        np.asarray(w))
    if w.ndim != 2 or not (num_classes <= w.shape[0]
                           < max(2 * num_classes, c_pad + 1)):
        raise ValueError(f"'{what}' shape {tuple(w.shape)} does not hold "
                         f"this config's {num_classes} classes (e.g. a "
                         f"different class count)")
    if w.shape[0] >= c_pad:
        return w[:c_pad]
    return torch.cat([w, w.new_zeros((c_pad - w.shape[0], w.shape[1]))])


def _place_classes(state: SVTrainState, w, what: str) -> torch.Tensor:
    """This rank's shard of the global classifier array ``w``."""
    c_pad = _padded_classes(state.num_classes, _n_model(state.mesh))
    w = _class_rows(w, state.num_classes, c_pad, what)
    if state.mesh is not None:
        w = shard(w, model_sharded(state.mesh))
    return w


def init_sv_train_state(model: torch.nn.Module, cfg: SVTrainConfig, *,
                        seed: int = 0, device=DEFAULT_DEVICE,
                        cls_w: Optional[torch.Tensor] = None,
                        mesh: Optional[Mesh] = None) -> SVTrainState:
    """The model moved to ``device`` (the mesh's, when given), a classifier
    weight (Xavier uniform over [num_classes, embedding_size], drawn from a
    ``torch.Generator`` seeded with ``seed + 1``, unless given as the global
    array), padded to a multiple of the model axis with zero rows and this
    rank's class shard taken, zero SGD buffers, step 0."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    if cls_w is None:
        limit = math.sqrt(6.0 / (cfg.num_classes + cfg.embedding_size))
        gen = torch.Generator().manual_seed(seed + 1)
        cls_w = (torch.rand((cfg.num_classes, cfg.embedding_size),
                            generator=gen) * 2 - 1) * limit
    if not isinstance(cls_w, torch.Tensor):
        cls_w = torch.tensor(np.asarray(cls_w), dtype=torch.float32)
    state = SVTrainState(model, None, {}, 0, num_classes=cfg.num_classes,
                         mesh=mesh)
    cls_w = _place_classes(state, cls_w, "cls_w").to(dev).clone()
    state.cls_w = cls_w.requires_grad_(True)
    state.momentum = {"model": {n: torch.zeros_like(p)
                                for n, p in model.named_parameters()},
                      "cls_w": torch.zeros_like(cls_w)}
    return state


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


def _flat_all_reduce(tensors, mesh: Mesh, axes) -> list:
    """``tensors`` summed over ``axes`` through one flat buffer."""
    if mesh.group(axes) is None:
        return list(tensors)
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), mesh,
                       axes)
    return [part.view_as(t) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def _rows_of_model_rank0(x, labels, mesh: Mesh) -> tuple:
    """The batch of the data row's model-axis rank 0 on every rank of the
    row: the model axis's shards must score the same rows (the loader's
    crops and speed draws are per process)."""
    group = mesh.group("model")
    if group is None:
        return x, labels
    src = mesh.members("model")[0]
    x, labels = x.contiguous().clone(), labels.contiguous().clone()
    torch.distributed.broadcast(x, src=src, group=group)
    torch.distributed.broadcast(labels, src=src, group=group)
    return x, labels


def make_sv_train_step(model: torch.nn.Module, cfg: SVTrainConfig,
                       feature_fn: Optional[Callable] = None,
                       mesh: Optional[Mesh] = None) -> Callable:
    """``step(state, batch) -> metrics``: one SGD step on ``state`` in place.

    ``batch``: ``{'wavs': [B, L] float32 or int16 PCM, 'labels': [B]}`` on
    the state's device when ``feature_fn`` (e.g. ``KaldiFbank(mean_norm=
    True)``) is given, else ``{'feats': [B, T, F], 'labels'}``; on a
    ``mesh`` (the state's) ``B`` is this rank's share of the global batch.
    ``metrics``: ``loss`` and ``acc`` (of the global batch) as 0-d tensors
    on the device (no host sync), ``lr`` and ``margin`` as 0-d float32 CPU
    tensors."""
    check_train_options(model, cfg)
    remat_whole = cfg.remat and enable_remat(model)
    batch_key = "wavs" if feature_fn is not None else "feats"
    m, wd = cfg.momentum, cfg.weight_decay
    half = cfg.compute_dtype == "bfloat16"
    n_model = _n_model(mesh)
    n_data = 1 if mesh is None else mesh.shape["data"]
    c_pad = _padded_classes(cfg.num_classes, n_model)
    c_local = c_pad // n_model
    offset = 0 if mesh is None else mesh.index("model") * c_local
    model_group = None if mesh is None else mesh.group("model")

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
            if mesh is not None:
                x, labels = _rows_of_model_rank0(x, labels, mesh)
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
                if c_pad != cfg.num_classes:
                    # padded class columns never win nor contribute
                    col = offset + torch.arange(c_local, device=cos.device)
                    cos = torch.where(col < cfg.num_classes, cos,
                                      cos.new_tensor(-1.0))
                ce = sharded_arc_margin_loss(cos, labels, offset,
                                             float(margin), cfg.scale,
                                             cfg.easy_margin, model_group)
                global_b = cos.shape[0] * n_data
                # every model rank holds the same loss: / n_model, so the
                # psums' backward, which sums the ranks' cotangents, gives
                # the true partials
                loss = ce.sum() / (global_b * n_model)
                grads = torch.autograd.grad(loss,
                                            list(params) + [state.cls_w])
            with torch.no_grad():
                top = pmax(cos.max(dim=-1).values, model_group)
                local = labels - offset
                owned = (local >= 0) & (local < c_local)
                tgt = cos.gather(1, torch.where(
                    owned, local, torch.zeros_like(local))[:, None])[:, 0]
                tgt = torch.where(owned, tgt, torch.zeros_like(tgt))
                if model_group is not None:
                    all_reduce_(tgt, mesh, "model")
                acc = (tgt >= top - 1e-7).to(torch.float32).sum() / global_b
                grads, loss = list(grads), loss.detach()
                if mesh is not None:
                    *g_bb, loss = _flat_all_reduce(
                        grads[:-1] + [loss.reshape(1)], mesh, AXES)
                    g_w, acc = _flat_all_reduce(
                        [grads[-1], acc.reshape(1).to(grads[-1].dtype)],
                        mesh, "data")
                    grads = g_bb + [g_w]
                    loss, acc = loss[0], acc[0].to(torch.float32)
                leaves = list(params) + [state.cls_w]
                bufs = ([state.momentum["model"][n] for n in names]
                        + [state.momentum["cls_w"]])
                g = torch._foreach_add(grads, leaves, alpha=wd)
                torch._foreach_mul_(bufs, m)
                torch._foreach_add_(bufs, g)
                d = torch._foreach_add(g, bufs, alpha=m) if cfg.nesterov \
                    else bufs
                torch._foreach_add_(leaves, d, alpha=-float(lr))
                if mesh is not None:
                    _mean_batch_stats(state.model, mesh)
        state.step += 1
        return {"loss": loss, "acc": acc, "lr": lr, "margin": margin}

    return step


def _mean_batch_stats(model: torch.nn.Module, mesh: Mesh) -> None:
    """The BatchNorm running statistics averaged over the whole mesh (the
    JAX step's ``pmean`` of ``batch_stats``), so the replicas stay equal."""
    stats = [b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    if not stats or mesh.group(AXES) is None:
        return
    for b, mean in zip(stats, _flat_all_reduce(stats, mesh, AXES)):
        b.copy_(mean / mesh.size)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _global_classes(state: SVTrainState, w: torch.Tensor) -> np.ndarray:
    """The global classifier array (padded rows included) from this rank's
    shard: a collective on a mesh."""
    if state.mesh is not None:
        w = all_gather(w.detach(), state.mesh, "model")
    return _numpy(w)


def state_tree(state: SVTrainState) -> Dict:
    """The checkpoint tree of ``state`` (numpy arrays); on a mesh every
    rank calls it (it gathers ``cls_w``)."""
    return {"model": {k: _numpy(v)
                      for k, v in state.model.state_dict().items()},
            "cls_w": _global_classes(state, state.cls_w),
            "momentum": {"model": {k: _numpy(v) for k, v in
                                   state.momentum["model"].items()},
                         "cls_w": _global_classes(state,
                                                  state.momentum["cls_w"])},
            "step": np.asarray(state.step, np.int32)}


def flax_state_tree(state: SVTrainState) -> Dict:
    """The checkpoint tree of ``state`` in the JAX trainer's layout
    (``params``, ``batch_stats``, ``cls_w``, ``momentum/params``,
    ``momentum/cls_w``, ``step``), which either package's trainer resumes;
    on a mesh every rank calls it (it gathers ``cls_w``)."""
    model = state.model
    names = (getattr(model, "flax_joined_names", ()),
             getattr(model, "flax_dense_names", ()))
    variables = flax_from_state_dict(model.state_dict(), *names)
    moments = flax_from_state_dict(state.momentum["model"], *names)
    return {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "cls_w": _global_classes(state, state.cls_w),
            "momentum": {"params": moments["params"],
                         "cls_w": _global_classes(state,
                                                  state.momentum["cls_w"])},
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
    """Load a checkpoint tree of either trainer, written on any mesh, into
    ``state``: the model (``strict=True``) and ``cls_w`` (this rank's class
    shard), and with ``optimizer`` the SGD buffers and the step (a warm
    start leaves them reset)."""
    model = state.model
    like = model.state_dict()
    sd = model_state_dict_from_tree(tree, like)
    for k, v in sd.items():
        if k in like:
            _check_shape(k, v, like[k])
    model.load_state_dict(sd, strict=True)
    cls_w = _place_classes(state, tree["cls_w"], "cls_w")
    _check_shape("cls_w", cls_w, state.cls_w)
    with torch.no_grad():
        state.cls_w.copy_(cls_w)
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
        state.momentum["cls_w"].copy_(
            _place_classes(state, mom["cls_w"], "momentum/cls_w"))
    state.step = int(np.asarray(tree["step"]))
