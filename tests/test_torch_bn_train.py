"""The port's BatchNorm in training mode against Flax's.

The JAX models build ``flax.linen.BatchNorm`` with its default momentum
0.99 and update the running variance with the biased batch variance; torch's
BatchNorm defaults to momentum 0.1 and the unbiased variance. The port's
``models/common.py`` layers keep torch's modules and state_dict names and
update their statistics as Flax does; the forward output still normalises
with the batch statistics.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.common import (
    BN_EPS, batch_norm1d, batch_norm2d, frozen_running_stats)
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from tests.test_torch_eres2netv2 import jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
             embedding_size=32)


# (torch layout, channel axis moved last for Flax)
@pytest.mark.parametrize("kind,shape,affine", [
    ("2d", (4, 6, 5, 7), True),
    ("1d", (5, 6, 9), True),
    ("1d", (5, 6, 9), False),
    ("1d", (8, 6), True),
])
def test_bn_layer_updates_like_flax(kind, shape, affine):
    rng = np.random.default_rng(len(shape) * 10 + affine)
    C = shape[1]
    layer = batch_norm2d(C) if kind == "2d" else batch_norm1d(C, affine=affine)
    flax_bn = fnn.BatchNorm(use_running_average=False, epsilon=BN_EPS,
                            use_bias=affine, use_scale=affine)
    to_flax = (0, *range(2, len(shape)), 1)
    xs = [(rng.standard_normal(shape) * rng.uniform(0.5, 3)
           + rng.uniform(-2, 2)).astype(np.float32) for _ in range(3)]
    variables = flax_bn.init(jax.random.PRNGKey(0), xs[0].transpose(to_flax))
    params = variables.get("params", {})
    if affine:
        params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                  "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    sd = state_dict_from_flax({"params": params, "batch_stats": stats})
    layer.load_state_dict(sd, strict=True)
    layer.train()
    for x in xs:
        out, mutated = flax_bn.apply({"params": params, "batch_stats": stats},
                                     x.transpose(to_flax),
                                     mutable=["batch_stats"])
        stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy().transpose(to_flax),
                                   np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.running_mean.numpy(), stats["mean"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(), stats["var"],
                               rtol=0, atol=1e-6)
    assert int(layer.num_batches_tracked) == 3


def test_bn_eval_mode_and_frozen_block_leave_the_statistics():
    layer = batch_norm2d(3)
    x = torch.randn(2, 3, 4, 5)
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    layer.eval()
    layer(x)
    layer.train()
    with frozen_running_stats():
        out = layer(x)
    for k, v in layer.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the frozen forward still normalises with the batch statistics
    want = torch.nn.functional.batch_norm(x, None, None, layer.weight,
                                          layer.bias, True, 0.0, BN_EPS)
    torch.testing.assert_close(out, want)
    assert layer.momentum == pytest.approx(0.01)


def test_eres2netv2_batch_stats_after_one_train_forward():
    jmodel = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jmodel)
    feats = np.random.default_rng(3).standard_normal((4, 40, 80)).astype(
        np.float32)
    out, mutated = jmodel.apply(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]},
        jnp.asarray(feats), train=True, mutable=["batch_stats"])
    want = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"])})

    model = ERes2NetV2(**SMALL)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.train()
    got = model(torch.from_numpy(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-4, atol=1e-4)
    sd = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
