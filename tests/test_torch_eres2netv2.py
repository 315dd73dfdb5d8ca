"""The PyTorch port's ERes2NetV2 (models/eres2netv2.py) and weight converter
(compat/flax_convert.py) against the JAX package.

Weights come from a JAX init with randomised BatchNorm statistics, cross over
through ``state_dict_from_flax`` and load with ``strict=True``. Embeddings
are compared after dividing both by the reference's largest magnitude (the
two geometries' outputs differ in scale by ~7x), at rtol = atol = 3e-4.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.compat.torch_convert import export_torch_state_dict
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.compat.flax_convert import (
    load_torch_checkpoint, state_dict_from_flax)
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2, eres2netv2_w24s4ep4
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(num_blocks=(2, 2, 1, 1), m_channels=16, feat_dim=80,
             embedding_size=32)
GEOMETRIES = {"s2e2": dict(base_width=26, scale=2, expansion=2),
              "s4e4": dict(base_width=24, scale=4, expansion=4)}


def jax_variables(model, t=40, seed=0):
    """JAX init with randomised BN running stats, as nested dicts of numpy
    arrays. Means are drawn around 0 (N(0, 0.1)) and variances from
    U(0.5, 1.5): means of ~1, as tests/test_res2_fused.py draws them, push
    every pre-activation below 0, so the trunk would output zeros and only
    the projection would be compared."""
    feats = np.random.default_rng(seed).standard_normal((1, t, 80)).astype(
        np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), feats)
    rng = np.random.default_rng(seed + 1)

    def draw(path, v):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


def port_model(variables, **kw):
    model = ERes2NetV2(**kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def assert_close_scaled(got, want, tol):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_small_depth_matches_jax(geom):
    kw = {**SMALL, **GEOMETRIES[geom]}
    jm = JaxERes2NetV2(**kw)
    variables = jax_variables(jm, t=60)
    feats = np.random.default_rng(2).standard_normal((2, 60, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    with torch.inference_mode():
        out = port_model(variables, **kw)(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, 32)
    assert_close_scaled(out, ref, 3e-4)


@pytest.mark.parametrize("pooling_func", ["TAP", "TSDP"])
def test_pooling_and_second_embedding_layer_match_jax(pooling_func):
    kw = {**SMALL, **GEOMETRIES["s2e2"], "pooling_func": pooling_func,
          "two_emb_layer": True}
    jm = JaxERes2NetV2(**kw)
    variables = jax_variables(jm, t=60, seed=5)
    feats = np.random.default_rng(6).standard_normal((2, 60, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    model = port_model(variables, **kw)
    assert "seg_bn_1.running_mean" in model.state_dict()
    with torch.inference_mode():
        out = model(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, 32)
    assert_close_scaled(out, ref, 3e-4)


def test_state_dict_from_flax_matches_export():
    jm = JaxERes2NetV2(**SMALL)
    variables = jax_variables(jm)
    ours = state_dict_from_flax(variables)
    theirs = export_torch_state_dict(variables)
    bn_counts = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - bn_counts == set(theirs)
    assert len(bn_counts) == sum(k.endswith("running_mean") for k in theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the keys are exactly the port module's state_dict keys
    assert set(ours) == set(ERes2NetV2(**SMALL).state_dict())


def test_checkpoint_roundtrip_strips_ddp_prefix(tmp_path):
    model = ERes2NetV2(**SMALL)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "m.ckpt")
    loaded = load_torch_checkpoint(str(tmp_path / "m.ckpt"))
    assert set(loaded) == set(model.state_dict())
    ERes2NetV2(**SMALL).load_state_dict(loaded, strict=True)


def test_full_size_parameter_counts():
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    assert abs(count(ERes2NetV2()) - 17.86) < 0.05
    assert abs(count(eres2netv2_w24s4ep4()) - 53.5) < 0.05


def test_fold_cache_follows_loaded_weights():
    kw = {**SMALL, **GEOMETRIES["s2e2"]}
    variables = jax_variables(JaxERes2NetV2(**kw))
    model = port_model(variables, **kw)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 50, 80)).astype(np.float32))
    blk = model.layer1[0]
    assert blk.fusable and not model.layer3[0].fusable
    with torch.inference_mode():
        first = model(feats)
    fold = blk.folded()
    assert blk.folded() is fold  # folded once per loaded weights
    sd = {k: v * 1.5 if k.endswith("conv1.weight") else v
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    assert not blk._folds
    with torch.inference_mode():
        second = model(feats)
    assert not torch.equal(first, second)
    model.train()
    assert not blk._folds
    model.eval()
    with torch.inference_mode():
        assert torch.equal(model(feats), second)
