"""Self-supervised (RDINO, SDPN) training on one card, with an EMA teacher.

The counterpart of ``speaker3d_tpu/train/ssl_train.py``. A step takes the
sample-major batch ``{'global_wavs': [B, G, Lg], 'local_wavs': [B, V,
Ll]}`` on the state's device, computes the mel features there
(``feature_fn``, ``ops/melspec.py``) and lays the crops out crop-major,
``[G*B, T, F]``, as the reference's loss expects. Then:

- the teacher's forward without gradients but in training mode: it
  normalises with batch statistics and updates its own running statistics;
- the student's forward: RDINO runs the globals and then the locals as two
  separate BatchNorm passes (the running statistics chain from one to the
  next, the crops are not concatenated); SDPN runs the locals;
- the loss (``train/ssl_losses.py``): DINO + the VICReg regulariser, or
  SDPN's prototype loss + ME-MAX + KoLeo on the backbone embeddings;
- the SGD update, written out as the JAX step's ``_tree_update_sgd`` in its
  order, per parameter: clip to ``min(1, clip / (||g|| + 1e-6))``, zero
  ``last_layer``'s gradients while frozen (the first ``freeze_last_layer``
  epochs), add ``wd * p`` for every parameter of two or more dimensions
  whose name does not end in ``bias``, ``b = 0.9 b + g``, ``p -= lr b``.
  The frozen gain ``weight_g`` [out, 1] gets no gradient but is 2-D, so it
  decays; ``last_layer`` keeps its decay and momentum during the freeze:
  both as the JAX step (ROADMAP.md, known reference caveats), unlike
  ``torch.optim.SGD``. SDPN's prototypes are a group of their own: their
  own lr schedule (``proto_lr``), no decay, no clip;
- the teacher's EMA, ``t = m t + (1 - m) s``, over the parameters only:
  its BatchNorm statistics are the ones its own forward wrote.

The schedules (lr, weight decay, teacher momentum, teacher temperature) are
float32 functions of the step counter before its increment, the cosine
taken in float64 and rounded once (``train/schedulers.py``). The step runs
in fp32 with TF32 off for its duration, as ``train/sv_train.py``'s does.

``state_tree`` / ``load_state_tree`` carry the state as the JAX trainer's
``ssl_state`` tree (``student`` and ``teacher`` with the Flax ``params``
and ``batch_stats``, ``momentum``, ``center`` or ``prototypes`` and
``proto_momentum``, ``step``), so either package reads, embeds with and
resumes the other's experiments. One card: the losses' cross-card
reductions are identities (M14 for more).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.train import ssl_losses
from speaker3d_tpu_torch.train.schedulers import _f32, _f64_once


def ssl_cosine_schedule(step, *, base_value, final_value, total_steps,
                        warmup_steps=0, start_warmup_value=0.0):
    """Linear warm-up from ``start_warmup_value``, then a cosine from
    ``base_value`` to ``final_value`` at ``total_steps``; a 0-d float32
    tensor."""
    step = _f32(step)
    warm = start_warmup_value + (base_value - start_warmup_value) * (
        step / max(warmup_steps, 1))
    i = step - warmup_steps
    n = max(total_steps - warmup_steps, 1)
    cos = final_value + 0.5 * (base_value - final_value) * (
        1 + _f64_once(torch.cos, math.pi * i / n))
    return torch.where(step < warmup_steps, warm, cos)


class SSLTrainConfig(NamedTuple):
    # schedules
    base_lr: float = 0.2           # already scaled by the batch / 256
    min_lr: float = 1e-5
    epochs: int = 150
    step_per_epoch: int = 1000
    warmup_epochs: int = 10
    weight_decay: float = 1e-4
    weight_decay_end: float = 1e-4
    momentum_teacher: float = 0.996
    sgd_momentum: float = 0.9
    clip_grad: float = 3.0
    freeze_last_layer: int = 1     # epochs
    # dino
    ncrops: int = 6                # 2 global + 4 local (RDINO)
    out_dim: int = 65536
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.07
    warmup_teacher_temp_epochs: int = 30
    student_temp: float = 0.1
    center_momentum: float = 0.9
    reg_std_coeff: float = 5.0
    reg_cov_coeff: float = 1.0
    reg_weight: float = 1.0
    # sdpn
    num_proto: int = 1024
    output_dim: int = 256
    proto_lr: float = 0.2
    tau: float = 0.1
    sharpen_T: float = 0.25
    num_local_views: int = 4
    memax_weight: float = 1.0
    koleo_weight: float = 0.1
    use_sinkhorn: bool = True


class SSLTrainState:
    """Student and teacher (combiners), the student's SGD buffers by
    parameter name, the step, and ``center`` (RDINO) or ``prototypes`` and
    ``proto_momentum`` (SDPN)."""

    def __init__(self, student: torch.nn.Module, teacher: torch.nn.Module,
                 momentum: Dict[str, torch.Tensor], step: int = 0,
                 center: Optional[torch.Tensor] = None,
                 prototypes: Optional[torch.Tensor] = None,
                 proto_momentum: Optional[torch.Tensor] = None):
        self.student = student
        self.teacher = teacher
        self.momentum = momentum
        self.step = step
        self.center = center
        self.prototypes = prototypes
        self.proto_momentum = proto_momentum


def init_ssl_state(model: torch.nn.Module, cfg: SSLTrainConfig,
                   variant: str = "rdino", device=DEFAULT_DEVICE,
                   generator: Optional[torch.Generator] = None
                   ) -> SSLTrainState:
    """``model`` (initialised) on ``device`` as the student, a copy as the
    teacher (the two start equal), zero buffers; RDINO's centre at 0,
    SDPN's prototypes uniform in +-sqrt(1 / output_dim) from
    ``generator``."""
    dev = resolve_device(device)
    student = model.to(dev)
    teacher = copy.deepcopy(student)
    for p in teacher.parameters():
        p.requires_grad_(False)
    momentum = {n: torch.zeros_like(p) for n, p in student.named_parameters()}
    dtype = next(iter(momentum.values())).dtype
    state = SSLTrainState(student, teacher, momentum)
    if variant == "rdino":
        state.center = torch.zeros((1, cfg.out_dim), device=dev, dtype=dtype)
    elif variant == "sdpn":
        k = (1.0 / cfg.output_dim) ** 0.5
        protos = torch.empty((cfg.num_proto, cfg.output_dim))
        protos.uniform_(-k, k, generator=generator)
        state.prototypes = protos.to(dev, dtype)
        state.proto_momentum = torch.zeros_like(state.prototypes)
    else:
        raise ValueError(f"unknown SSL variant {variant!r}")
    return state


def _crop_major(x: torch.Tensor, feature_fn) -> torch.Tensor:
    """[B, G, ...] sample-major -> crop-major [G*B, T, F], the features
    computed per crop."""
    b, g = x.shape[0], x.shape[1]
    x = x.reshape((b * g,) + tuple(x.shape[2:]))
    if feature_fn is not None:
        x = feature_fn(x)
    x = x.reshape((b, g) + tuple(x.shape[1:])).transpose(0, 1)
    return x.reshape((g * b,) + tuple(x.shape[2:]))


def _schedules(cfg: SSLTrainConfig, step: int) -> Dict[str, torch.Tensor]:
    """The step's lr, weight decay, teacher momentum and epoch (float32)."""
    total = cfg.epochs * cfg.step_per_epoch
    warmup = cfg.warmup_epochs * cfg.step_per_epoch
    return {
        "lr": ssl_cosine_schedule(step, base_value=cfg.base_lr,
                                  final_value=cfg.min_lr, total_steps=total,
                                  warmup_steps=warmup),
        "wd": ssl_cosine_schedule(step, base_value=cfg.weight_decay,
                                  final_value=cfg.weight_decay_end,
                                  total_steps=total),
        "m_teacher": ssl_cosine_schedule(step,
                                         base_value=cfg.momentum_teacher,
                                         final_value=1.0, total_steps=total),
        "epoch": _f32(step) / cfg.step_per_epoch,
    }


def _grads(loss, module: torch.nn.Module, extra=()):
    """Gradients of ``loss`` by parameter name (zeros for a frozen or
    unused parameter, as the JAX gradient tree holds), and those of the
    ``extra`` tensors."""
    named = list(module.named_parameters())
    live = [p for _, p in named if p.requires_grad]
    got = list(torch.autograd.grad(loss, live + list(extra),
                                   allow_unused=True))
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(live + list(extra), got)]
    it = iter(got[:len(live)])
    grads = {n: (next(it) if p.requires_grad else torch.zeros_like(p))
             for n, p in named}
    return grads, got[len(live):]


def sgd_update_(module: torch.nn.Module, grads: Dict[str, torch.Tensor],
                momentum: Dict[str, torch.Tensor], *, lr: float, wd: float,
                sgd_momentum: float, clip: Optional[float],
                freeze_mask: float) -> None:
    """The JAX step's ``_tree_update_sgd`` on ``module``'s parameters in
    place (see the module docstring)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            g = grads[name]
            if clip is not None and clip > 0:
                norm = torch.linalg.vector_norm(g)
                g = g * torch.clamp(clip / (norm + 1e-6), max=1.0)
            if "last_layer" in name:
                g = g * freeze_mask
            if p.ndim >= 2 and not name.endswith("bias"):
                g = g + wd * p
            b = momentum[name]
            b.mul_(sgd_momentum).add_(g)
            p.sub_(lr * b)


def ema_(teacher: torch.nn.Module, student: torch.nn.Module,
         m: torch.Tensor) -> None:
    """``t = t * m + (1 - m) * s`` over the parameters (``m`` float32)."""
    keep, take = float(m), float(_f32(1.0) - m)
    with torch.no_grad():
        t = [p for p in teacher.parameters()]
        s = [p for p in student.parameters()]
        torch._foreach_mul_(t, keep)
        torch._foreach_add_(t, torch._foreach_mul(s, take))


def make_rdino_train_step(cfg: SSLTrainConfig,
                          feature_fn: Optional[Callable] = None) -> Callable:
    """``step(state, batch) -> metrics`` (``loss``, ``dino_loss``,
    ``reg_loss`` 0-d device tensors; ``lr``, ``teacher_momentum`` 0-d
    float32 CPU tensors); the state in place. The model is an
    ``RDINOCombiner``."""
    key = "wavs" if feature_fn is not None else "feats"
    w_steps = cfg.warmup_teacher_temp_epochs * cfg.step_per_epoch

    def step(state: SSLTrainState, batch) -> Dict[str, torch.Tensor]:
        s = _schedules(cfg, state.step)
        step_f = _f32(state.step)
        t_temp = torch.where(
            step_f < w_steps,
            cfg.warmup_teacher_temp + (cfg.teacher_temp
                                       - cfg.warmup_teacher_temp)
            * step_f / max(w_steps, 1),
            _f32(cfg.teacher_temp))
        freeze = float(s["epoch"] >= cfg.freeze_last_layer)
        with matmul_precision("float32"):
            g_in = _crop_major(batch[f"global_{key}"], feature_fn)
            l_in = _crop_major(batch[f"local_{key}"], feature_fn)
            state.teacher.train()
            with torch.no_grad():
                tea_reg, tea_out = state.teacher(g_in)
            state.student.train()
            s_reg_g, s_out_g = state.student(g_in)
            _, s_out_l = state.student(l_in)
            student_out = torch.cat([s_out_g, s_out_l], dim=0)
            dloss, new_center = ssl_losses.dino_loss(
                student_out, tea_out, state.center, ncrops=cfg.ncrops,
                teacher_temp=float(t_temp), student_temp=cfg.student_temp,
                center_momentum=cfg.center_momentum)
            rloss = ssl_losses.reg_loss(
                tea_reg, s_reg_g, std_coeff=cfg.reg_std_coeff,
                cov_coeff=cfg.reg_cov_coeff)
            loss = dloss + cfg.reg_weight * rloss
            grads, _ = _grads(loss, state.student)
            sgd_update_(state.student, grads, state.momentum,
                        lr=float(s["lr"]), wd=float(s["wd"]),
                        sgd_momentum=cfg.sgd_momentum, clip=cfg.clip_grad,
                        freeze_mask=freeze)
            ema_(state.teacher, state.student, s["m_teacher"])
        state.center = new_center.detach()
        state.step += 1
        return {"loss": loss.detach(), "dino_loss": dloss.detach(),
                "reg_loss": rloss.detach(), "lr": s["lr"],
                "teacher_momentum": s["m_teacher"]}

    return step


def make_sdpn_train_step(cfg: SSLTrainConfig,
                         feature_fn: Optional[Callable] = None) -> Callable:
    """``step(state, batch) -> metrics`` (``loss``, ``ploss``, ``memax``,
    ``koleo`` 0-d device tensors; ``lr`` a 0-d float32 CPU tensor); the
    state in place. The model is an ``SDPNCombiner``; the batch holds clean
    globals (the teacher's) and augmented locals (the student's
    anchors)."""
    key = "wavs" if feature_fn is not None else "feats"
    total = cfg.epochs * cfg.step_per_epoch
    warmup = cfg.warmup_epochs * cfg.step_per_epoch
    labels: Dict[tuple, torch.Tensor] = {}

    def step(state: SSLTrainState, batch) -> Dict[str, torch.Tensor]:
        s = _schedules(cfg, state.step)
        proto_lr = ssl_cosine_schedule(state.step, base_value=cfg.proto_lr,
                                       final_value=cfg.min_lr,
                                       total_steps=total, warmup_steps=warmup)
        freeze = float(s["epoch"] >= cfg.freeze_last_layer)
        where = (state.prototypes.device, state.prototypes.dtype)
        if where not in labels:
            labels[where] = torch.eye(cfg.num_proto, device=where[0],
                                      dtype=where[1])
        with matmul_precision("float32"):
            g_in = _crop_major(batch[f"global_{key}"], feature_fn)
            l_in = _crop_major(batch[f"local_{key}"], feature_fn)
            state.teacher.train()
            with torch.no_grad():
                _, target_views = state.teacher(g_in)
            state.student.train()
            protos = state.prototypes.detach().requires_grad_(True)
            anchor_emb, anchor_views = state.student(l_in)
            ploss, memax, _ = ssl_losses.sdpn_loss(
                anchor_views, target_views, protos, labels[where],
                tau=cfg.tau, T=cfg.sharpen_T, num_views=cfg.num_local_views,
                use_sinkhorn=cfg.use_sinkhorn)
            chunks = anchor_emb.reshape(cfg.num_local_views, -1,
                                        anchor_emb.shape[-1])
            ke = sum(ssl_losses.koleo_loss(chunks[i])
                     for i in range(cfg.num_local_views))
            loss = ploss + cfg.memax_weight * memax + cfg.koleo_weight * ke
            grads, (g_proto,) = _grads(loss, state.student, (protos,))
            sgd_update_(state.student, grads, state.momentum,
                        lr=float(s["lr"]), wd=float(s["wd"]),
                        sgd_momentum=cfg.sgd_momentum, clip=cfg.clip_grad,
                        freeze_mask=freeze)
            with torch.no_grad():
                state.proto_momentum.mul_(cfg.sgd_momentum).add_(g_proto)
                state.prototypes = (state.prototypes
                                    - float(proto_lr) * state.proto_momentum)
            ema_(state.teacher, state.student, s["m_teacher"])
        state.step += 1
        return {"loss": loss.detach(), "ploss": ploss.detach(),
                "memax": memax.detach(), "koleo": ke.detach(),
                "lr": s["lr"]}

    return step


def _flax(module: torch.nn.Module, sd) -> dict:
    return flax_from_state_dict(
        sd, getattr(module, "flax_joined_names", ()),
        getattr(module, "flax_dense_names", ()))


def state_tree(state: SSLTrainState) -> Dict:
    """The JAX trainer's ``ssl_state`` tree of ``state`` (numpy arrays)."""
    def model(m):
        tree = _flax(m, m.state_dict())
        return {"params": tree["params"],
                "batch_stats": tree.get("batch_stats", {})}

    tree = {"student": model(state.student), "teacher": model(state.teacher),
            "momentum": _flax(state.student, state.momentum)["params"],
            "step": np.asarray(state.step, np.int32)}
    if state.center is not None:
        tree["center"] = state.center.detach().cpu().numpy()
    else:
        tree["prototypes"] = state.prototypes.detach().cpu().numpy()
        tree["proto_momentum"] = state.proto_momentum.detach().cpu().numpy()
    return tree


def load_state_tree(state: SSLTrainState, tree: Dict) -> None:
    """Load an ``ssl_state`` tree of either package's trainer into
    ``state`` (each tensor keeps its device and dtype)."""
    for name in ("student", "teacher"):
        module = getattr(state, name)
        module.load_state_dict(state_dict_from_flax(
            tree[name], like=module.state_dict()), strict=True)
    like = state.student.state_dict()
    mom = state_dict_from_flax({"params": tree["momentum"]}, like=like)
    if sorted(mom) != sorted(state.momentum):
        raise KeyError("momentum does not match the model's parameters")
    with torch.no_grad():
        for name, buf in state.momentum.items():
            buf.copy_(mom[name])
    state.step = int(np.asarray(tree["step"]))
    keys = (("center",) if state.center is not None
            else ("prototypes", "proto_momentum"))
    for key in keys:
        like_t = getattr(state, key)
        setattr(state, key, torch.tensor(np.asarray(tree[key]),
                                         dtype=like_t.dtype,
                                         device=like_t.device))
