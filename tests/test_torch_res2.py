"""The PyTorch port's BN-folded Res2 block (ops/kernels/res2_block_kernel.py)
against the JAX package's Pallas kernel (interpret mode) and an unfused
block, and the full 17.8M geometry against ``fused_res2_apply_fn``.

On the CPU the wrapper runs the kernel's plain version;
tests/test_torch_gpu.py holds the CUDA kernel against it on the card.
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
from tests.test_torch_eres2netv2 import jax_variables, port_model
from tests.torch_threads import cap_torch_threads  # noqa: F401


def _bn(rng, n):
    return {"scale": rng.uniform(0.5, 1.5, n), "bias": rng.standard_normal(n),
            "mean": rng.standard_normal(n) * 0.1, "var": rng.uniform(0.5, 2, n)}


def _block_weights(seed, cin, w, cout):
    """Random block weights in both packages' forms (as the JAX package's
    tests/test_res2_fused.py draws them)."""
    rng = np.random.default_rng(seed)
    params = {
        "conv1": {"kernel": rng.standard_normal((1, 1, cin, 2 * w)) * 0.3},
        "bn1": _bn(rng, 2 * w), "bns.0": _bn(rng, w), "bns.1": _bn(rng, w),
        "convs.0": {"kernel": rng.standard_normal((3, 3, w, w)) * 0.3},
        "convs.1": {"kernel": rng.standard_normal((3, 3, w, w)) * 0.3},
        "conv3": {"kernel": rng.standard_normal((1, 1, 2 * w, cout)) * 0.3},
        "bn3": _bn(rng, cout),
        "shortcut.0": {"kernel": rng.standard_normal((1, 1, cin, cout)) * 0.3},
        "shortcut.1": _bn(rng, cout),
    }
    params = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), params)
    stats = {k: {"mean": params[k].pop("mean"), "var": params[k].pop("var")}
             for k in ("bn1", "bns.0", "bns.1", "bn3", "shortcut.1")}
    sd = {}
    for mod, leaves in params.items():
        for leaf, v in leaves.items():
            if leaf == "kernel":
                sd[f"{mod}.weight"] = torch.from_numpy(v.transpose(3, 2, 0, 1).copy())
            else:
                sd[f"{mod}.{'weight' if leaf == 'scale' else leaf}"] = torch.from_numpy(v)
    for mod, st in stats.items():
        sd[f"{mod}.running_mean"] = torch.from_numpy(st["mean"])
        sd[f"{mod}.running_var"] = torch.from_numpy(st["var"])
    return params, stats, sd


def _unfused(x, sd, stride, w):
    """Conv + BN + Hardtanh(0, 20) as separate torch ops (inference BN)."""
    import torch.nn.functional as F

    def bn(h, key):
        g = sd[f"{key}.weight"] / torch.sqrt(sd[f"{key}.running_var"] + 1e-5)
        b = sd[f"{key}.bias"] - sd[f"{key}.running_mean"] * g
        return h * g[:, None, None] + b[:, None, None]

    r20 = lambda v: torch.clamp(v, 0, 20)
    h = r20(bn(F.conv2d(x, sd["conv1.weight"], stride=stride), "bn1"))
    y1 = r20(bn(F.conv2d(h[:, :w], sd["convs.0.weight"], padding=1), "bns.0"))
    y2 = r20(bn(F.conv2d(h[:, w:] + y1, sd["convs.1.weight"], padding=1), "bns.1"))
    out = bn(F.conv2d(torch.cat([y1, y2], 1), sd["conv3.weight"]), "bn3")
    res = bn(F.conv2d(x, sd["shortcut.0.weight"], stride=stride), "shortcut.1")
    return r20(out + res)


@pytest.mark.parametrize("stride", [1, 2])
def test_block_matches_pallas_and_unfused(stride):
    cin, w, cout, f, t = 16, 6, 32, 20, 100
    params, stats, sd = _block_weights(0, cin, w, cout)
    x = np.random.default_rng(1).standard_normal((2, f, t, cin)).astype(np.float32)
    want = np.asarray(res2_block_fused(
        jnp.asarray(x), jax_fold(params, stats), stride=stride, interpret=True))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())     # NHWC -> NCHW
    folded = rk.fold_res2_block(sd)
    launches = rk.res2_block.launches
    got = rk.res2_block(xt, folded, stride)
    assert rk.res2_block.launches == launches  # CPU: plain version
    assert got.shape == (2, cout, -(-f // stride), -(-t // stride))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, _unfused(xt, sd, stride, w),
                               rtol=2e-4, atol=2e-4)


def test_flagship_geometry_matches_fused_apply_fn():
    """The 17.8M geometry (widths 26/52) at t=50: the port's eval forward
    (layer1-2 through the folded block) against the JAX package's
    interceptor path through the Pallas kernel."""
    jm = JaxERes2NetV2(feat_dim=80, embedding_size=192)
    variables = jax_variables(jm, t=50)
    feats = np.random.default_rng(3).standard_normal((1, 50, 80)).astype(
        np.float32)
    want = np.asarray(fused_res2_apply_fn(jm, variables,
                                          compute_dtype=jnp.float32,
                                          interpret=True)(jnp.asarray(feats)))
    model = port_model(variables, feat_dim=80, embedding_size=192)
    assert sum(b.fusable for b in (*model.layer1, *model.layer2)) == 7
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    cos = float(np.sum(got * want) / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos > 0.999999, cos
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=3e-4, atol=3e-4)


def test_identity_shortcut_fold():
    """Blocks with Cin == Cout and stride 1 have no shortcut conv: the fold
    carries none and the plain version adds x itself."""
    _, _, sd = _block_weights(4, 32, 6, 32)
    sd = {k: v for k, v in sd.items() if not k.startswith("shortcut")}
    folded = rk.fold_res2_block(sd)
    assert folded.wsc is None and folded.p_wsc is None
    x = torch.rand((1, 32, 6, 9))
    out = rk.res2_block_plain(x, folded)
    sd_sc = dict(sd, **{"shortcut.0.weight": torch.eye(32)[:, :, None, None],
                        "shortcut.1.weight": torch.ones(32),
                        "shortcut.1.bias": torch.zeros(32),
                        "shortcut.1.running_mean": torch.zeros(32),
                        "shortcut.1.running_var": torch.full((32,), 1 - 1e-5)})
    torch.testing.assert_close(out, _unfused(x, sd_sc, 1, 6), rtol=2e-4, atol=2e-4)
