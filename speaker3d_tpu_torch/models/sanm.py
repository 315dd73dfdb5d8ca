"""SAN-M encoder (Paraformer): memory-equipped self-attention.

The counterpart of ``speaker3d_tpu/models/sanm.py``, after funasr's public
``SANMEncoder``: the input scaled by sqrt(d_model) plus a sinusoidal
position encoding over the input width (positions from 1, the sin half then
the cos half); a first block ``encoders0.0`` from the input width to
d_model with no residual around its attention when the widths differ, then
``encoders.{i}`` blocks d_model -> d_model; pre-LN attention and ReLU FFN;
a final ``after_norm``. The attention's value stream also feeds an FIR
memory (a depthwise ``fsmn_block`` conv with Flax's padding: (k-1)//2 on
the left, the rest on the right), added after ``linear_out``.

Submodule names are the Flax ones, so ``compat/flax_convert.py`` carries
the weights both ways (``feed_forward.w_1`` is one Flax name holding a dot:
``FLAX_JOINED_NAMES``). LayerNorm's epsilon is Flax's 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default
# Flax submodule names that hold a dot (compat/flax_convert.py)
FLAX_JOINED_NAMES = ("feed_forward.w_1", "feed_forward.w_2")


def funasr_sinusoidal_pe(t: int, depth: int) -> np.ndarray:
    """funasr SinusoidalPositionEncoder.encode: positions 1..t, half-sin /
    half-cos concatenation over ``depth`` (must be even); float64, then
    float32."""
    if depth % 2:
        raise ValueError(f"funasr positional encoding needs even depth, "
                         f"got {depth}")
    positions = np.arange(1, t + 1, dtype=np.float64)[:, None]
    log_timescale_increment = np.log(10000.0) / (depth / 2 - 1)
    inv_timescales = np.exp(np.arange(depth // 2, dtype=np.float64)
                            * -log_timescale_increment)[None, :]
    scaled_time = positions * inv_timescales
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


class SANMAttention(nn.Module):
    """Multi-head self-attention plus the value stream's FIR memory, added
    after the output projection."""

    def __init__(self, in_size: int, d_model: int, num_heads: int,
                 kernel_size: int = 11):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        self.left = (kernel_size - 1) // 2
        self.right = kernel_size - 1 - self.left
        self.linear_q_k_v = nn.Linear(in_size, 3 * d_model)
        self.fsmn_block = nn.Conv1d(d_model, d_model, kernel_size,
                                    groups=d_model, bias=False)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, x):
        b, t, _ = x.shape
        h, d = self.num_heads, self.d_model
        dk = d // h
        q, k, v = self.linear_q_k_v(x).split(d, dim=-1)
        fir = self.fsmn_block(F.pad(v.transpose(1, 2),
                                    (self.left, self.right)))
        mem = v + fir.transpose(1, 2)

        def split(z):
            return z.reshape(b, t, h, dk).transpose(1, 2)

        q_h = split(q) * torch.tensor(dk, dtype=x.dtype) ** -0.5
        att = torch.matmul(q_h, split(k).transpose(-1, -2))
        att = torch.softmax(att.float(), dim=-1).to(x.dtype)
        ctx = torch.matmul(att, split(v)).transpose(1, 2).reshape(b, t, d)
        return self.linear_out(ctx) + mem


class FeedForward(nn.Module):
    """``w_1`` -> ReLU -> ``w_2``."""

    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.w_1 = nn.Linear(d_model, ffn_dim)
        self.w_2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x):
        return self.w_2(F.relu(self.w_1(x)))


class SANMLayer(nn.Module):
    """Pre-LN attention (a residual only when ``in_size == d_model``), then a
    pre-LN ReLU FFN with its residual."""

    def __init__(self, in_size: int, d_model: int, num_heads: int,
                 ffn_dim: int, kernel_size: int = 11):
        super().__init__()
        self.residual = in_size == d_model
        self.norm1 = nn.LayerNorm(in_size, eps=LAYER_NORM_EPS)
        self.self_attn = SANMAttention(in_size, d_model, num_heads,
                                       kernel_size)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.feed_forward = FeedForward(d_model, ffn_dim)

    def forward(self, x):
        att = self.self_attn(self.norm1(x))
        x = x + att if self.residual else att
        return x + self.feed_forward(self.norm2(x))


class SANMEncoder(nn.Module):
    """LFR/CMVN features [B, T, input_dim] -> [B, T, d_model].

    ``num_layers`` counts every block: ``encoders0.0`` plus
    ``num_layers - 1`` blocks ``encoders.{i}``."""

    def __init__(self, input_dim: int = 560, d_model: int = 512,
                 num_heads: int = 4, ffn_dim: int = 2048, num_layers: int = 8,
                 kernel_size: int = 11):
        super().__init__()
        self.input_dim, self.d_model = input_dim, d_model
        self.encoders0 = nn.ModuleList([SANMLayer(
            input_dim, d_model, num_heads, ffn_dim, kernel_size)])
        self.encoders = nn.ModuleList(
            SANMLayer(d_model, d_model, num_heads, ffn_dim, kernel_size)
            for _ in range(num_layers - 1))
        self.after_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, x):
        t = x.shape[1]
        h = x * torch.tensor(np.sqrt(self.d_model), dtype=x.dtype)
        pe = torch.from_numpy(funasr_sinusoidal_pe(t, self.input_dim))
        h = h + pe.to(device=x.device, dtype=h.dtype)[None]
        for layer in (*self.encoders0, *self.encoders):
            h = layer(h)
        return self.after_norm(h)
