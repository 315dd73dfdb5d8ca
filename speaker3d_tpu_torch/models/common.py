"""Shared model helpers.

Every BatchNorm of the port's models comes from ``batch_norm2d`` /
``batch_norm1d``: torch's BatchNorm modules (same state_dict names, same
eval mode) whose training mode updates the running statistics as the JAX
package's ``flax.linen.BatchNorm`` does: ``running = 0.99 * running + 0.01 *
batch``, with the *biased* batch variance (torch's own default is momentum
0.1 with the unbiased variance). ``frozen_running_stats`` turns the update
off for a block, as the recomputation of a checkpointed block needs:
``checkpointed`` runs a function through ``torch.utils.checkpoint`` that
way, and ``remat_blocks`` runs each block of a ``Sequential`` through it.

In a bf16 train step (``train/sv_train.py``: bf16 input, bf16 casts of
the parameters) the training-mode forward is Flax's under
``bn_compute_dtype(bfloat16)``: batch statistics reduced in fp32, the
normalisation in fp32 with the bf16-rounded scale and bias, the output in
bf16, the running statistics fp32.

In eval mode with a bf16 input, bf16 running statistics and bf16 parameters
(a model cast to bf16, as ``eval/embedding.py::build_embedding_fn`` and
``eval/quant.py`` cast it), the forward is Flax's ``BatchNorm`` on
bf16-cast variables, one bf16 op at a time: ``y = x - mean``, ``mul =
rsqrt(var + eps)`` (eps rounded to bf16, as Flax's weakly typed epsilon),
``mul = mul * scale``, ``y = y * mul``, ``y = y + bias``, each rounded to
bf16, where torch's own kernel would normalise in fp32 and round once.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5  # Flax BatchNorm's default epsilon, which the JAX models use
BN_MOMENTUM = 0.99  # Flax BatchNorm's default, which the JAX models use

_frozen = [0]  # > 0 inside ``frozen_running_stats``


@contextlib.contextmanager
def frozen_running_stats():
    """Within the block, BatchNorm in training mode normalises with batch
    statistics but leaves its running statistics as they are."""
    _frozen[0] += 1
    try:
        yield
    finally:
        _frozen[0] -= 1


def _recompute_without_bn_updates():
    """``checkpoint``'s (forward, recompute) contexts: the recomputation in
    the backward must not update the running statistics a second time."""
    return contextlib.nullcontext(), frozen_running_stats()


def checkpointed(fn, *args):
    """``fn(*args)`` whose activations are recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, as the JAX package's
    ``nn.remat`` / ``jax.checkpoint``); the recomputation leaves the
    BatchNorm running statistics alone, so they end as a plain step leaves
    them."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_recompute_without_bn_updates)


def remat_blocks(layer: nn.Sequential, x, remat: bool):
    """``layer(x)``; with ``remat``, in training with autograd on, each of
    its blocks through ``checkpointed``."""
    if not (remat and layer.training and torch.is_grad_enabled()):
        return layer(x)
    for block in layer:
        x = checkpointed(block, x)
    return x


class _FlaxStatsBatchNorm:
    """Training-mode forward with Flax's running-statistics update."""

    def forward(self, x):
        if not self.training and _bf16_eval(self, x):
            return self._flax_bf16_eval(x)
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        # momentum 1.0 leaves exactly this batch's mean and unbiased
        # variance in the scratch buffers, from the same fused kernel that
        # normalises the output (the same call when frozen, so that a
        # checkpointed block's recomputation saves the same tensors)
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        weight, bias = self.weight, self.bias
        if weight is not None and x.dtype != mean.dtype:
            # a bf16 step (train/sv_train.py): Flax normalises in fp32 with
            # the bf16-rounded scale and bias and rounds the output to x's
            # dtype; F.batch_norm takes fp32 weights beside a bf16 input
            weight, bias = weight.float(), bias.float()
        out = F.batch_norm(x, mean, var, weight, bias, True, 1.0, self.eps)
        if _frozen[0]:
            return out
        n = x.numel() // x.shape[1]
        keep = BN_MOMENTUM
        with torch.no_grad():
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            # unbiased -> biased: Flax updates with the biased variance
            self.running_var.mul_(keep).add_(
                var, alpha=(1.0 - keep) * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out

    def _flax_bf16_eval(self, x):
        """Flax's eval-mode normalisation with bf16 variables, op by op in
        bf16 (see the module docstring)."""
        shape = (1, -1) + (1,) * (x.ndim - 2)
        eps = torch.tensor(self.eps, dtype=x.dtype).item()
        # the root in fp32, rounded once: torch's CPU rsqrt on bf16 is off
        # by an ulp on a quarter of the values
        mul = torch.rsqrt((self.running_var + eps).float()).to(x.dtype)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - self.running_mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y


def _bf16_eval(bn, x) -> bool:
    """Whether ``bn`` (in eval mode) holds bf16 running statistics and
    parameters and sees a bf16 input."""
    return (x.dtype == torch.bfloat16 and bn.running_mean is not None
            and bn.running_mean.dtype == torch.bfloat16
            and (bn.weight is None or bn.weight.dtype == torch.bfloat16))


class BatchNorm2d(_FlaxStatsBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxStatsBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm3d(_FlaxStatsBatchNorm, nn.BatchNorm3d):
    pass


def batch_norm2d(channels: int, eps: float = BN_EPS) -> nn.BatchNorm2d:
    return BatchNorm2d(channels, eps=eps, momentum=1.0 - BN_MOMENTUM)


def batch_norm1d(channels: int, affine: bool = True,
                 eps: float = BN_EPS) -> nn.BatchNorm1d:
    return BatchNorm1d(channels, eps=eps, affine=affine,
                       momentum=1.0 - BN_MOMENTUM)


def batch_norm3d(channels: int, eps: float = BN_EPS) -> nn.BatchNorm3d:
    return BatchNorm3d(channels, eps=eps, momentum=1.0 - BN_MOMENTUM)


def relu20(x):
    """The reference's ReLU: Hardtanh(0, 20)."""
    return torch.clamp(x, 0.0, 20.0)


def trunk_freq(feat_dim: int, stride2_stages: int = 3) -> int:
    """Frequency bins left after ``stride2_stages`` stride-2, pad-1, 3x3
    stages (ceil(f / 2) each)."""
    f = feat_dim
    for _ in range(stride2_stages):
        f = (f + 1) // 2
    return f


def add_embedding_layers(module: nn.Module, stats_dim: int,
                         embedding_size: int, two_emb_layer: bool) -> None:
    """The reference's embedding layers after pooling, under its names:
    ``seg_1`` (Linear), and with ``two_emb_layer`` ``seg_bn_1`` (affine-free
    BatchNorm) and ``seg_2`` (Linear)."""
    module.seg_1 = nn.Linear(stats_dim, embedding_size)
    if two_emb_layer:
        module.seg_bn_1 = batch_norm1d(embedding_size, affine=False)
        module.seg_2 = nn.Linear(embedding_size, embedding_size)


def embedding_layers(module: nn.Module, stats):
    """``seg_1``, then ReLU -> ``seg_bn_1`` -> ``seg_2`` where the module has
    a second embedding layer."""
    embed_a = module.seg_1(stats)
    if not hasattr(module, "seg_2"):
        return embed_a
    return module.seg_2(module.seg_bn_1(torch.relu(embed_a)))
