"""LR and margin schedules as functions of the step counter.

The counterpart of ``speaker3d_tpu/train/schedulers.py``: linear warm-up ->
cosine -> ``min_lr`` floor, a x0.1 staircase, and the margin ramp (exp or
linear) between two epochs. Each takes the step counter (int or tensor) and
returns a 0-d float32 tensor, computed in float32 as the JAX functions are.
The transcendental functions take their fp32 argument in float64 and round
the result once (``_f64_once``): XLA's fp32 ``cos`` and ``exp`` are
correctly rounded where torch's are one ulp off at some arguments, and near
the end of the cosine ``1 + cos`` cancels, so that ulp became 50 ulp of the
lr.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def _f64_once(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of the fp32 tensor ``x``, evaluated in float64 and rounded once
    to float32."""
    return fn(x.to(torch.float64)).to(torch.float32)


def warmup_cosine_lr(step, *, min_lr, max_lr, warmup_epoch, fix_epoch,
                     step_per_epoch):
    step = _f32(step)
    warmup_step = warmup_epoch * step_per_epoch
    fix_step = fix_epoch * step_per_epoch
    warm = min_lr + (max_lr - min_lr) * (step / max(warmup_step, 1))
    cos = min_lr + 0.5 * (max_lr - min_lr) * (
        1 + _f64_once(torch.cos, math.pi * (step - warmup_step)
                      / max(fix_step - warmup_step, 1)))
    return torch.where(step < warmup_step, warm,
                       torch.where(step < fix_step, cos, _f32(min_lr)))


def step_lr(step, *, lr, step_per_epoch, step_epoch_size):
    """x0.1 staircase."""
    step = _f32(step)
    step_size = step_epoch_size * step_per_epoch
    return lr * torch.pow(_f32(0.1), torch.floor(step / step_size))


def margin_at_step(step, *, increase_start_epoch, fix_epoch, step_per_epoch,
                   initial_margin, final_margin, increase_type="exp"):
    step = _f32(step)
    start = increase_start_epoch * step_per_epoch
    fix = fix_epoch * step_per_epoch
    increase_step = max(fix - start, 1)
    cur = step - start
    a, b = 1.0, 1e-3
    if increase_type == "exp":
        ratio = 1.0 - _f64_once(
            torch.exp, (cur / increase_step)
            * torch.log(_f32(b / (a + 1e-6)))) * a
    else:
        ratio = cur / increase_step
    margin = initial_margin + (final_margin - initial_margin) * ratio
    return torch.where(step < start, _f32(initial_margin),
                       torch.where(step >= fix, _f32(final_margin), margin))
