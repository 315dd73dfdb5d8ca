"""Self-supervised losses: DINO, the VICReg-style regulariser, SDPN, KoLeo.

The counterpart of ``speaker3d_tpu/train/ssl_losses.py`` on one card:

- ``dino_loss``: teacher centering and temperature sharpening, the
  cross-view cross entropy that skips same-view pairs, the centre's EMA;
- ``reg_loss``: VICReg std and covariance terms on crop-averaged outputs;
- ``sdpn_loss``: soft nearest-neighbour classification against learnable
  prototypes, sharpened targets with Sinkhorn-Knopp normalisation, ME-MAX;
- ``koleo_loss``: the Kozachenko-Leonenko spread regulariser (nearest
  neighbour by ``dots - 2 * eye``, the first index on a tie).

The JAX functions reduce across replicas (``psum``, ``all_gather``) when
given a mesh axis; at world size 1 those reductions are identities, which
is what these functions compute. ``world_size > 1`` raises: data-parallel
SSL training is ROADMAP.md M14.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MULTI_CARD_NOT_PORTED = ("cross-card SSL reductions (world size > 1) are "
                         "ROADMAP.md M14; the SSL trainer runs on one card")


def _one_card(world_size: int) -> None:
    if world_size != 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)


def dino_loss(student_output, teacher_output, center, *, ncrops: int,
              teacher_temp, student_temp: float = 0.1,
              center_momentum: float = 0.9, world_size: int = 1):
    """(loss, new_center). student_output [ncrops*B, K], teacher_output
    [2*B, K], center [1, K]."""
    _one_card(world_size)
    k = student_output.shape[-1]
    student_out = (student_output / student_temp).reshape(ncrops, -1, k)
    teacher_out = torch.softmax((teacher_output - center) / teacher_temp,
                                dim=-1).detach().reshape(2, -1, k)
    total = 0.0
    n_terms = 0
    for iq in range(2):
        q = teacher_out[iq]
        for v in range(ncrops):
            if v == iq:
                continue
            ce = torch.sum(-q * F.log_softmax(student_out[v], dim=-1), dim=-1)
            total = total + ce.mean()
            n_terms += 1
    loss = total / n_terms
    batch_center = (teacher_output.detach().sum(dim=0, keepdim=True)
                    / teacher_output.shape[0])
    new_center = center * center_momentum + batch_center * (1 - center_momentum)
    return loss, new_center


def _off_diagonal_sumsq(x):
    return torch.sum(torch.square(x)) - torch.sum(torch.square(torch.diagonal(x)))


def reg_loss(tea_reg_out, stu_reg_out, *, std_coeff: float, cov_coeff: float,
             global_ncrops: int = 2, world_size: int = 1):
    """VICReg-style std + covariance regulariser on crop-averaged
    outputs."""
    _one_card(world_size)
    dim = tea_reg_out.shape[-1]
    x = stu_reg_out.reshape(global_ncrops, -1, dim).mean(dim=0)
    y = tea_reg_out.reshape(global_ncrops, -1, dim).mean(dim=0)
    batch = x.shape[0]
    x = x - x.mean(dim=0)
    y = y - y.mean(dim=0)
    std_x = torch.sqrt(torch.var(x, dim=0, unbiased=True) + 1e-4)
    std_y = torch.sqrt(torch.var(y, dim=0, unbiased=True) + 1e-4)
    std_loss = (torch.mean(torch.relu(1 - std_x)) / 2
                + torch.mean(torch.relu(1 - std_y)) / 2)
    cov_x = (x.T @ x) / (batch - 1)
    cov_y = (y.T @ y) / (batch - 1)
    cov_loss = (_off_diagonal_sumsq(cov_x) / dim
                + _off_diagonal_sumsq(cov_y) / dim)
    return std_coeff * std_loss + cov_coeff * cov_loss


def sharpen(p, T):
    sharp = torch.pow(p, 1.0 / T)
    return sharp / torch.sum(sharp, dim=1, keepdim=True)


def snn(query, supports, support_labels, tau: float = 0.1):
    """Soft nearest-neighbour classifier."""
    q = query / torch.clamp(torch.linalg.vector_norm(query, dim=-1,
                                                     keepdim=True), min=1e-12)
    s = supports / torch.clamp(torch.linalg.vector_norm(supports, dim=-1,
                                                        keepdim=True),
                               min=1e-12)
    return torch.softmax(q @ s.T / tau, dim=1) @ support_labels


def distributed_sinkhorn(Q, num_itr: int = 3, world_size: int = 1):
    """Sinkhorn-Knopp normalisation of the targets Q [B, K]."""
    _one_card(world_size)
    Q = Q.T  # [K, B]
    B = Q.shape[1] * world_size
    K = Q.shape[0]
    Q = Q / torch.sum(Q)
    for _ in range(num_itr):
        rows = torch.sum(Q, dim=1, keepdim=True)
        Q = Q / rows / K
        Q = Q / torch.sum(Q, dim=0, keepdim=True) / B
    return (Q * B).T


def sdpn_loss(anchor_views, target_views, prototypes, proto_labels, *,
              tau: float = 0.1, T: float = 0.25, num_views: int = 4,
              me_max: bool = True, use_sinkhorn: bool = True,
              world_size: int = 1):
    """(loss, rloss, targets)."""
    _one_card(world_size)
    probs = snn(anchor_views, prototypes, proto_labels, tau)
    with torch.no_grad():
        targets = sharpen(snn(target_views, prototypes, proto_labels, tau), T)
        if use_sinkhorn:
            targets = distributed_sinkhorn(targets)
        targets = torch.cat([targets] * num_views, dim=0)
    loss = torch.mean(torch.sum(-targets * torch.log(torch.clamp(
        probs, min=1e-12)), dim=1))
    rloss = 0.0
    if me_max:
        avg = torch.mean(probs, dim=0)
        rloss = (torch.sum(avg * torch.log(torch.clamp(avg, min=1e-12)))
                 + torch.log(torch.tensor(float(avg.shape[0]),
                                          device=avg.device)))
    return loss, rloss, targets


def koleo_loss(student_output, eps: float = 1e-8):
    x = student_output / torch.clamp(torch.linalg.vector_norm(
        student_output, dim=-1, keepdim=True), min=eps)
    dots = x @ x.T
    n = x.shape[0]
    # exclude self (the diagonal goes below -1)
    dots = dots - 2.0 * torch.eye(n, dtype=dots.dtype, device=dots.device)
    nn_idx = torch.argmax(dots, dim=1)
    diffs = x - x[nn_idx]
    dist = torch.sqrt(torch.clamp(torch.sum(torch.square(diffs), dim=-1),
                                  min=0.0) + 1e-16)
    return -torch.mean(torch.log(dist + eps))
