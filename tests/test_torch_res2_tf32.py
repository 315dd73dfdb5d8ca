"""The 3xTF32 operands of the port's Res2-block kernel, on the CPU.

``ops/kernels/tf32.py``'s ``tf32_split`` and ``pack_b`` prepare the weights
that csrc/res2_block.cu multiplies on the tensor cores. The block's 3xTF32
numerics are emulated here with F.conv2d on split operands (three terms, the
small cross terms first) and held against the JAX package's Pallas kernel in
interpret mode, at the tolerance of tests/test_torch_res2.py; ``res2_block``
takes that plain version only for a CPU tensor. tests/test_torch_gpu.py holds
the kernel itself against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speaker3d_tpu.ops.pallas.res2_block_kernel import (
    fold_res2_block as jax_fold, res2_block_fused)
from speaker3d_tpu_torch.models.common import relu20
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from speaker3d_tpu_torch.ops.kernels import tf32
from tests.test_torch_res2 import _block_weights
from tests.torch_threads import cap_torch_threads  # noqa: F401


def _kmajor(k):  # OIHW -> [(kh*KW + kw)*I + i, O], the kernel's K order
    o, i, kh, kw = k.shape
    return k.permute(2, 3, 1, 0).reshape(kh * kw * i, o)


def _unpack_b(packed):
    """The padded K-major matrix (big + small) that ``pack_b`` packed."""
    ks, nt = packed.shape[:2]
    v = (packed[..., :2] + packed[..., 2:]).view(ks, nt, 8, 4, 2)
    return v.permute(0, 4, 3, 1, 2).reshape(ks * 8, nt * 8)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_tf32_split(scale):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32) * scale)
    big, small = tf32.tf32_split(a)
    # big is a TF32 value: its low 13 mantissa bits are zero
    assert int((big.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((small.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # big rounds to nearest: |a - big| <= half a TF32 ulp, 2^-11 |a|
    assert bool(((a - big).abs() <= 2.0 ** -11 * a.abs()).all())
    # big + small carries a to 2^-21 of itself
    assert bool(((a - big - small).abs() <= 2.0 ** -21 * a.abs()).all())


def test_tf32_split_rounds_ties_away_from_zero():
    # 1 + 2^-11 lies halfway between two TF32 values: rna rounds it up
    a = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    big, _ = tf32.tf32_split(a)
    torch.testing.assert_close(big, torch.tensor([1 + 2.0 ** -10,
                                                  -(1 + 2.0 ** -10), 1.0]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("w", [6, 26, 52])
@pytest.mark.parametrize("which", ["expand", "conv3x3", "project"])
def test_pack_b_fragments_and_padding(w, which):
    cin, cout = 2 * w + 4, 4 * w
    k, n = {"expand": (cin, 2 * w), "conv3x3": (9 * w, w),
            "project": (2 * w, cout)}[which]
    kmat = torch.from_numpy(np.random.default_rng(w).standard_normal((k, n))
                            .astype(np.float32))
    packed = tf32.pack_b(kmat)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    assert packed.shape == (kp // 8, np_ // 8, 32, 4)
    # unpacking gives back the K-major weight, zero in the padding
    full = _unpack_b(packed)
    assert full.shape == (kp, np_)
    torch.testing.assert_close(full[:k, :n], kmat, rtol=2.0 ** -21, atol=0)
    assert float(full[k:].abs().sum()) == 0 and float(full[:, n:].abs().sum()) == 0
    # lane 4g + t of (k-step ks, n-tile nt) holds the mma B fragment
    # b0 = W[8 ks + t, 8 nt + g], b1 = W[8 ks + t + 4, 8 nt + g], big then small
    padded = torch.zeros((kp, np_))
    padded[:k, :n] = kmat
    big, small = tf32.tf32_split(padded)
    for ks, nt, g, t in [(0, 0, 0, 0), (kp // 8 - 1, np_ // 8 - 1, 7, 3),
                         (kp // 16, 0, 3, 2)]:
        lane = packed[ks, nt, 4 * g + t]
        want = [big[8 * ks + t, 8 * nt + g], big[8 * ks + t + 4, 8 * nt + g],
                small[8 * ks + t, 8 * nt + g], small[8 * ks + t + 4, 8 * nt + g]]
        assert lane.tolist() == torch.stack(want).tolist()


def test_fold_packs_every_weight():
    _, _, sd = _block_weights(2, 16, 6, 32)
    p = rk.fold_res2_block(sd)
    for packed, oihw in [(p.p_w1, p.w1), (p.p_wc1, p.wc1), (p.p_wc2, p.wc2),
                         (p.p_w3, p.w3), (p.p_wsc, p.wsc)]:
        k, n = _kmajor(oihw).shape
        torch.testing.assert_close(_unpack_b(packed)[:k, :n], _kmajor(oihw),
                                   rtol=2.0 ** -21, atol=0)


def _conv_3xtf32(x, w, b=None, **kw):
    """F.conv2d in 3xTF32: a_s*w_b + a_b*w_s + a_b*w_b on split operands."""
    xb, xs = tf32.tf32_split(x)
    wb, ws = tf32.tf32_split(w)
    out = F.conv2d(xs, wb, **kw) + F.conv2d(xb, ws, **kw) + F.conv2d(xb, wb, **kw)
    return out if b is None else out + b[:, None, None]


def _block_3xtf32(x, p, stride):
    """res2_block_plain's structure with every conv in 3xTF32."""
    w = p.width
    h = relu20(_conv_3xtf32(x, p.w1, p.b1, stride=stride))
    y1 = relu20(_conv_3xtf32(h[:, :w], p.wc1, p.bc1, padding=1))
    y2 = relu20(_conv_3xtf32(h[:, w:] + y1, p.wc2, p.bc2, padding=1))
    out = _conv_3xtf32(torch.cat([y1, y2], dim=1), p.w3, p.b3)
    res = x if p.wsc is None else _conv_3xtf32(x, p.wsc, stride=stride)
    return relu20(out + res)


@pytest.mark.parametrize("stride", [1, 2])
def test_3xtf32_block_matches_pallas(stride):
    cin, w, cout, f, t = 16, 6, 32, 20, 100
    params, stats, sd = _block_weights(0, cin, w, cout)
    x = np.random.default_rng(1).standard_normal((2, f, t, cin)).astype(np.float32)
    want = np.asarray(res2_block_fused(
        jnp.asarray(x), jax_fold(params, stats), stride=stride, interpret=True))
    got = _block_3xtf32(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                        rk.fold_res2_block(sd), stride)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_res2_block_takes_the_plain_version_only_on_the_cpu(device):
    _, _, sd = _block_weights(5, 16, 6, 32)
    p = rk.fold_res2_block(sd)
    x = torch.rand((1, 16, 5, 7), generator=torch.Generator().manual_seed(0))
    if device == "cpu":
        torch.testing.assert_close(rk.res2_block(x, p), rk.res2_block_plain(x, p),
                                   rtol=0, atol=0)
    else:
        with pytest.raises(ValueError):
            rk.res2_block(x.to(device), p)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    _, _, sd = _block_weights(5, 16, 6, 32)
    with pytest.raises(ValueError):
        rk.res2_block_cuda(torch.rand((1, 16, 5, 7)), rk.fold_res2_block(sd))
