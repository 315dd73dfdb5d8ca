"""The bf16 Res2 block of the port (ops/kernels/res2_block_kernel.py at
``dtype=torch.bfloat16``) against the JAX package's Pallas kernel at its
bf16 serving dtype, in interpret mode, and a small ERes2NetV2 in bf16 eval
against ``fused_res2_apply_fn(..., compute_dtype=bfloat16)``.

The JAX side is compiled with ``xla_allow_excess_precision`` off: XLA on the
CPU would otherwise keep some bf16 results in fp32. Both sides round to bf16
at the same points (h, y1, u = s2 + y1, y2, the output) and sum in fp32 in
their own orders, so a value that lies near a bf16 rounding boundary may
round the other way: a few elements differ by a bf16 ulp (2^-8 of the
output's scale at most). On the CPU
the wrapper runs the plain version; tests/test_torch_gpu.py holds the CUDA
kernel against it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.ops.pallas.res2_block_kernel import (
    fold_res2_block as jax_fold, fused_res2_apply_fn, res2_block_fused)
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from tests.test_torch_eres2netv2 import SMALL, jax_variables, port_model
from tests.test_torch_res2 import _block_weights
from tests.torch_threads import cap_torch_threads  # noqa: F401

NO_EXCESS = {"xla_allow_excess_precision": False}
BF16_ULP = 2.0 ** -8
# One block: at most this share of the elements differ (measured: none at 5
# of the 6 shapes, 0.013% at stride 1, w = 26 with the shortcut conv), none
# by more than one bf16 ulp of the output's scale (measured 0.8).
BLOCK_DIFF_SHARE = 1e-3
BLOCK_MAX_ULPS = 1.0


def _jax_block(x, params, stats, stride):
    fn = jax.jit(lambda a: res2_block_fused(
        a, jax_fold(params, stats, dtype=jnp.bfloat16), stride=stride,
        interpret=True))
    xb = jnp.asarray(x, jnp.bfloat16)
    return np.asarray(fn.lower(xb).compile(NO_EXCESS)(xb).astype(jnp.float32))


def _drop_shortcut(params, stats, sd):
    params = {k: v for k, v in params.items() if not k.startswith("shortcut")}
    stats = {k: v for k, v in stats.items() if not k.startswith("shortcut")}
    sd = {k: v for k, v in sd.items() if not k.startswith("shortcut")}
    return params, stats, sd


# (stride, w, shortcut conv): the identity shortcut takes stride 1 only
@pytest.mark.parametrize("stride,w,shortcut", [
    (1, 26, True), (2, 26, True), (1, 26, False), (1, 8, True), (2, 8, True),
    (1, 8, False)])
def test_bf16_block_matches_pallas(stride, w, shortcut):
    cin, cout = (16, 32) if shortcut else (2 * w, 2 * w)
    params, stats, sd = _block_weights(0, cin, w, cout)
    if not shortcut:
        params, stats, sd = _drop_shortcut(params, stats, sd)
    x = np.random.default_rng(1).uniform(0, 2, (2, 12, 40, cin)).astype(
        np.float32)
    want = _jax_block(x, params, stats, stride)
    folded = rk.fold_res2_block(sd, dtype=torch.bfloat16)
    assert folded.dtype == torch.bfloat16 and folded.b1.dtype == torch.float32
    assert (folded.wsc is not None) == shortcut
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
    launches = (rk.res2_block.launches, rk.res2_block.launches_bf16)
    got = rk.res2_block(xt, folded, stride)
    assert (rk.res2_block.launches, rk.res2_block.launches_bf16) == launches
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert (got != want).mean() <= BLOCK_DIFF_SHARE, (got != want).mean()
    ulps = np.abs(got - want) / (float(np.abs(want).max()) * BF16_ULP)
    assert ulps.max() <= BLOCK_MAX_ULPS, ulps.max()


def test_bf16_fold_rounds_the_fp32_fold_once():
    """The bf16 fold is the fp32 fold rounded once to bf16 (biases fp32),
    and its packed fragments hold the rounded weights in mma order."""
    _, _, sd = _block_weights(2, 16, 26, 32)
    f32 = rk.fold_res2_block(sd)
    b16 = rk.fold_res2_block(sd, dtype=torch.bfloat16)
    for name in ("w1", "wc1", "wc2", "w3", "wsc"):
        torch.testing.assert_close(getattr(b16, name),
                                   getattr(f32, name).bfloat16(), rtol=0, atol=0)
    for name in ("b1", "bc1", "bc2", "b3"):
        torch.testing.assert_close(getattr(b16, name), getattr(f32, name),
                                   rtol=0, atol=0)
    # K = 9w = 234 pads to 240 (15 k-steps of 16), N = 26 to 32 (4 n-tiles)
    assert b16.p_wc1.shape == (15, 4, 32, 4)
    with pytest.raises(ValueError, match="dtype"):
        rk.fold_res2_block(sd, dtype=torch.float16)


def _mma_m16n8k16(a, packed):
    """What mma.sync.m16n8k16 (row.col, BF16) computes from an A [M, Kp]
    and the packed B fragments of ``pack_b_bf16``, lane by lane as the PTX
    fragment layout places them: lane 4g + t holds B[2t, g], B[2t + 1, g],
    B[2t + 8, g], B[2t + 9, g] of each (k-step, n-tile)."""
    ks, nt = packed.shape[:2]
    b = torch.zeros((ks * 16, nt * 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j, dk in enumerate((0, 1, 8, 9)):
            b[torch.arange(ks)[:, None] * 16 + 2 * t + dk,
              torch.arange(nt)[None, :] * 8 + g] = packed[:, :, lane, j].float()
    return a.float() @ b


def test_pack_b_bf16_fragment_order():
    rng = np.random.default_rng(3)
    kmat = torch.from_numpy(rng.standard_normal((234, 26)).astype(np.float32))
    packed = rk.pack_b_bf16(kmat)
    assert packed.shape == (15, 4, 32, 4) and packed.dtype == torch.bfloat16
    a = torch.from_numpy(rng.standard_normal((16, 240)).astype(np.float32))
    a[:, 234:] = 0
    want = a.bfloat16().float() @ torch.nn.functional.pad(
        kmat.bfloat16().float(), (0, 6, 0, 6))
    torch.testing.assert_close(_mma_m16n8k16(a.bfloat16(), packed), want,
                               rtol=1e-6, atol=1e-5)


def test_bf16_block_refuses_other_dtypes():
    _, _, sd = _block_weights(4, 16, 8, 32)
    folded = rk.fold_res2_block(sd, dtype=torch.bfloat16)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            rk.res2_block(torch.rand((1, 16, 6, 8), dtype=dtype), folded)
    with pytest.raises(ValueError, match="the fold"):
        rk.res2_block(torch.rand((1, 16, 6, 8)), folded)


def test_small_eres2netv2_bf16_matches_fused_apply_fn():
    """A small ERes2NetV2 (layer1-2 blocks through the bf16 block) in bf16
    eval against the JAX package's interceptor path through the Pallas
    kernel at bf16. Past the blocks every later layer carries the bf16
    flips of both sides further (tests/test_torch_embedding_dtype.py), so
    the embeddings are held at cosine: closer to the JAX bf16 forward than
    the port's fp32 forward is (measured 0.999985 and 0.999988 against
    0.99996 and 0.99997)."""
    jm = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jm, t=60)
    feats = np.random.default_rng(5).standard_normal((2, 60, 80)).astype(
        np.float32)
    fn = jax.jit(fused_res2_apply_fn(jm, variables, compute_dtype=jnp.bfloat16,
                                     interpret=True))
    want = np.asarray(fn.lower(feats).compile(NO_EXCESS)(feats)
                      .astype(jnp.float32))
    model = port_model(variables, **SMALL).to(torch.bfloat16)
    launches = rk.res2_block.launches_bf16
    with torch.inference_mode():
        got = model(torch.from_numpy(feats).bfloat16()).float().numpy()
    assert rk.res2_block.launches_bf16 == launches  # CPU: plain version
    assert model.layer1[0]._folds and all(
        key[1] == torch.bfloat16 for key in model.layer1[0]._folds)
    with torch.inference_mode():
        f32 = port_model(variables, **SMALL)(torch.from_numpy(feats)).numpy()
    cos = lambda a: np.sum(a * want, -1) / (np.linalg.norm(a, axis=-1)
                                            * np.linalg.norm(want, axis=-1))
    assert cos(got).min() > 0.99997, cos(got)
    assert cos(got).min() > cos(f32).max(), (cos(got), cos(f32))
