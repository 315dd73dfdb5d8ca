"""3xTF32 operands of the port's tensor-core kernels.

``csrc/fbank.cu`` and ``csrc/res2_block.cu`` multiply fp32 operands on the
tensor cores as three TF32 ``mma.sync.m16n8k8`` products, a_s*b_b + a_b*b_s
+ a_b*b_b, with each operand split into rna-TF32 big and small parts
(``csrc/tf32_mma.cuh``). Their weights are split and packed into B-fragment
order once, on the host, by ``pack_b``.
"""

from __future__ import annotations

import torch


def tf32_split(a: torch.Tensor):
    """(big, small) with big = rna_tf32(a), small = rna_tf32(a - big): the
    operand split of 3xTF32, as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero, low 13 mantissa bits cleared)."""

    def rna(v):
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(a)
    return big, rna(a.float() - big)


def round8(n: int) -> int:
    return -(-n // 8) * 8


def pack_b(kmat: torch.Tensor) -> torch.Tensor:
    """A K-major weight [K, N] as 3xTF32 ``mma.m16n8k8`` B fragments:
    [Kp/8, Np/8, 32, 4] with K and N zero-padded to multiples of 8 and, for
    k-step ks, n-tile nt and lane 4g + t, (b0 big, b1 big, b0 small, b1
    small) with b0 = W[8 ks + t, 8 nt + g] and b1 = W[8 ks + t + 4, 8 nt + g]."""
    k, n = kmat.shape
    m = kmat.new_zeros((round8(k), round8(n)), dtype=torch.float32)
    m[:k, :n] = kmat
    # [ks, j, t, nt, g] with k = 8 ks + 4 j + t -> [ks, nt, g, t, j]
    frag = lambda v: v.view(m.shape[0] // 8, 2, 4, m.shape[1] // 8, 8).permute(
        0, 3, 4, 2, 1).reshape(m.shape[0] // 8, m.shape[1] // 8, 32, 2)
    big, small = tf32_split(m)
    return torch.cat([frag(big), frag(small)], dim=-1).contiguous()
