"""Margin softmax losses.

The counterpart of ``speaker3d_tpu/train/losses.py``: AAM-softmax
(ArcMargin) with the reference's ``mmm`` fallback and ``easy_margin``,
AddMargin (CosFace) and plain cross entropy. The margin may be a number or
a 0-d CPU tensor, so one step function serves the whole margin ramp.

``sharded_arc_margin_loss`` is the JAX trainer's vocab-parallel loss: the
classes sharded over the ``model`` axis's process group, the row maximum,
the sum of exponentials and the target logit reduced across the shards
(``parallel/mesh.py``'s ``pmax`` and differentiable ``psum``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from speaker3d_tpu_torch.parallel.mesh import pmax, psum


def _margin_terms(margin):
    """cos m, sin m, th = cos(pi - m), mmm = 1 + cos(pi - m), in float32 as
    the JAX loss computes them; Python numbers, so no tensor crosses to the
    card for them."""
    m = np.float32(float(margin))
    pi_m = np.float32(math.pi) - m
    return (float(np.cos(m)), float(np.sin(m)), float(np.cos(pi_m)),
            float(np.float32(1.0) + np.cos(pi_m)))


def _phi(cosine, margin, easy_margin):
    cos_m, sin_m, th, mmm = _margin_terms(margin)
    sine = torch.sqrt(torch.clamp(1.0 - cosine.square(), 0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine)
    return torch.where(cosine > th, phi, cosine - mmm)


def arc_margin_logits(cosine, labels, margin, scale=32.0, easy_margin=False):
    """Scaled AAM logits."""
    phi = _phi(cosine, margin, easy_margin)
    one_hot = F.one_hot(labels.long(), cosine.shape[-1]).to(cosine.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * scale


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def arc_margin_loss(cosine, labels, margin, scale=32.0, easy_margin=False):
    return cross_entropy(arc_margin_logits(cosine, labels, margin, scale,
                                           easy_margin), labels)


def add_margin_loss(cosine, labels, margin, scale=32.0):
    one_hot = F.one_hot(labels.long(), cosine.shape[-1]).to(cosine.dtype)
    logits = (one_hot * (cosine - margin) + (1.0 - one_hot) * cosine) * scale
    return cross_entropy(logits, labels)


def entropy_loss(logits, labels):
    logits = logits.reshape(-1, logits.shape[-1])
    return cross_entropy(logits, labels.reshape(-1))


def sharded_arc_margin_loss(local_cosine, labels, shard_offset, margin,
                            scale=32.0, easy_margin=False, group=None):
    """Per-example AAM cross entropy [B] with the classes sharded over
    ``group`` (the model axis's process group; None: one shard, the whole
    class axis). ``local_cosine`` [B, C_local] is this shard's slice of the
    cosine logits, ``labels`` [B] the global class ids (the same on every
    shard), ``shard_offset`` the first class this shard owns. Every shard
    returns the same values; their gradients reach each shard's slice
    through the differentiable ``psum``, whose backward sums the
    cotangents, as JAX's does."""
    if group is None and shard_offset != 0:
        raise ValueError(f"a class shard at offset {shard_offset} needs the "
                         f"model axis's process group (group=None is one "
                         f"shard, which starts at 0)")
    c_local = local_cosine.shape[-1]
    local_label = labels.long() - shard_offset
    owned = (local_label >= 0) & (local_label < c_local)
    safe = torch.where(owned, local_label, torch.zeros_like(local_label))
    phi = _phi(local_cosine, margin, easy_margin)
    one_hot = (F.one_hot(safe, c_local).to(local_cosine.dtype)
               * owned[:, None].to(local_cosine.dtype))
    logits = (one_hot * phi + (1.0 - one_hot) * local_cosine) * scale
    # the max shift is inert in the value; detached, as in the JAX loss,
    # so no cotangent runs through the maximum
    top = pmax(logits.max(dim=-1).values.detach(), group)
    sumexp = psum(torch.exp(logits - top[:, None]).sum(dim=-1), group)
    target = psum(torch.where(owned, logits.gather(1, safe[:, None])[:, 0],
                              torch.zeros_like(top)), group)
    return top + torch.log(sumexp) - target
