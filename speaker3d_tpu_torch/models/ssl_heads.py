"""SSL projection heads and combiners (RDINO, SDPN).

The counterpart of ``speaker3d_tpu/models/ssl_heads.py``:

- ``RDINOHead``: a GELU MLP to ``add_dim`` (the VICReg-regularised output),
  ``add_layer`` to the bottleneck, L2 norm, and a weight-normed last layer
  whose gain stays frozen when ``norm_last_layer``; returns (reg_out, out).
- ``SDPNHead``: the MLP to the bottleneck, L2-normalised.
- ``RDINOCombiner`` returns the head's outputs; ``SDPNCombiner`` returns
  (backbone embedding, head output).

The MLP's layers are ``mlp.0``, ``mlp.2``, ``mlp.4`` (the GELUs hold the odd
indices, exact GELU), ``WeightNormedLinear`` owns ``weight_g`` [out, 1] and
``weight_v`` [out, in] under the reference's names (torch's
``parametrizations.weight_norm`` would rename them), so the state_dict keeps
the JAX package's names. A frozen gain has ``requires_grad=False`` but
stays in the trainer's update, which decays it (``train/ssl_train.py``).

Initial weights: a normal truncated at two standard deviations, std 0.02,
drawn from the given ``torch.Generator`` (biases 0, gains 1), as the JAX
heads' ``truncated_normal(0.02)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

INIT_STD = 0.02


def l2norm(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def trunc_normal_init_(weight: torch.Tensor,
                       generator: Optional[torch.Generator]) -> None:
    """A normal of std 0.02 truncated at +-2 std (``nn.init.trunc_normal_``'s
    default bounds are +-2 absolute)."""
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=INIT_STD, a=-2 * INIT_STD,
                              b=2 * INIT_STD, generator=generator)


def _linear(in_dim: int, out_dim: int, generator) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    trunc_normal_init_(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def _mlp(in_dim: int, hidden_dim: int, out_dim: int, nlayers: int,
         generator) -> nn.Module:
    if nlayers == 1:
        return _linear(in_dim, out_dim, generator)
    layers = [_linear(in_dim, hidden_dim, generator), nn.GELU()]
    for _ in range(nlayers - 2):
        layers += [_linear(hidden_dim, hidden_dim, generator), nn.GELU()]
    layers.append(_linear(hidden_dim, out_dim, generator))
    return nn.Sequential(*layers)


class WeightNormedLinear(nn.Module):
    """``W = g * v / ||v||_row``, no bias; ``x @ W.T``."""

    def __init__(self, in_dim: int, out_dim: int, trainable_gain: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1),
                                     requires_grad=trainable_gain)
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))
        trunc_normal_init_(self.weight_v, generator)

    def forward(self, x):
        v = self.weight_v
        w = self.weight_g * v / torch.clamp(
            torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)
        return x @ w.T


class RDINOHead(nn.Module):
    """Returns (reg_out [B, add_dim], out [B, out_dim])."""

    def __init__(self, in_dim: int = 512, out_dim: int = 65536,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 add_dim: int = 8192, nlayers: int = 3,
                 norm_last_layer: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = _mlp(in_dim, hidden_dim, add_dim, nlayers, generator)
        self.add_layer = _linear(add_dim, bottleneck_dim, generator)
        self.last_layer = WeightNormedLinear(
            bottleneck_dim, out_dim, trainable_gain=not norm_last_layer,
            generator=generator)

    def forward(self, x):
        reg_out = self.mlp(x)
        x = l2norm(self.add_layer(reg_out))
        return reg_out, self.last_layer(x)


class SDPNHead(nn.Module):
    """The L2-normalised MLP output [B, bottleneck_dim]."""

    def __init__(self, in_dim: int = 512, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = _mlp(in_dim, hidden_dim, bottleneck_dim, nlayers, generator)

    def forward(self, x):
        return l2norm(self.mlp(x))


class _Combiner(nn.Module):
    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    @property
    def flax_joined_names(self):
        return getattr(self.backbone, "flax_joined_names", ())

    @property
    def flax_dense_names(self):
        return getattr(self.backbone, "flax_dense_names", ())


class RDINOCombiner(_Combiner):
    """backbone -> head: (reg_out, dino_out)."""

    def forward(self, x):
        return self.head(self.backbone(x))


class SDPNCombiner(_Combiner):
    """backbone -> head: (backbone embedding, head output)."""

    def forward(self, x):
        emb = self.backbone(x)
        return emb, self.head(emb)
