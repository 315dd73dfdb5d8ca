"""Multi-speaker segmentation model (overlap detection) and its PIT loss.

The counterpart of ``speaker3d_tpu/models/segmentation.py``: the DFSMN
trunk of ``models/fsmn_vad.py`` with ``max_speakers`` outputs per frame,
trained with a permutation-invariant frame BCE. Speaker channels are only
consistent within one window; ``diar/overlap.py::post_process`` aligns them
to the global clusters per chunk.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from speaker3d_tpu_torch.models.fsmn_vad import FSMNTrunk


class FSMNSegmenter(FSMNTrunk):
    """Per-frame local-speaker activations.

    Input: [B, T, feat_dim] log-mel fbank (no mean-norm). Output: [B, T,
    max_speakers] activation logits (sigmoid -> P(active))."""

    def __init__(self, feat_dim: int = 80, hidden_dim: int = 128,
                 proj_dim: int = 64, num_layers: int = 4, lorder: int = 20,
                 rorder: int = 20, max_speakers: int = 3):
        super().__init__(feat_dim, hidden_dim, proj_dim, num_layers, lorder,
                         rorder, out_dim=max_speakers)
        self.max_speakers = max_speakers

    def forward(self, x):
        return self.trunk(x)


def bce_with_logits(logits, labels):
    """Elementwise BCE with logits in the stable form the JAX trainers
    write: max(l, 0) - l * y + log1p(exp(-|l|))."""
    return F.relu(logits) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))


def pit_bce(logits, labels):
    """Permutation-invariant frame BCE over the K! channel orders (K <= 4).

    logits, labels: [B, T, K]. Returns ([B] the least mean BCE over the
    permutations, [B, K] the label-channel order that reaches it; the first
    such order on a tie)."""
    k = logits.shape[-1]
    lg = logits[:, :, :, None]                     # [B, T, K, 1]
    lb = labels[:, :, None, :].to(logits.dtype)    # [B, T, 1, K]
    cost = bce_with_logits(lg, lb).mean(dim=1)     # [B, K, K]
    perms = torch.tensor(list(itertools.permutations(range(k))),
                         device=logits.device)     # [P, K]
    idx = torch.arange(k, device=logits.device)
    per_perm = cost[:, idx[None, :], perms].mean(-1)  # [B, P]
    # amin splits the gradient between tied permutations, as jnp.min does
    return per_perm.amin(dim=-1), perms[per_perm.argmin(dim=-1)]
