"""The PyTorch port's ERes2Net (models/eres2net.py) against the JAX
package's, and the port's registry against the JAX registry.

Weights come from a JAX init with randomised BatchNorm statistics
(``tests/test_torch_eres2netv2.py::jax_variables``), cross over through
``state_dict_from_flax`` and load with ``strict=True``. Embeddings are
compared after dividing both by the reference's largest magnitude, at
rtol = atol = 3e-4. On the CPU the scale-2 blocks of layer1-2 run the Res2
block kernel's plain version, as they do in the port's ERes2NetV2.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.cli import registry as jreg
from speaker3d_tpu.compat.torch_convert import (
    export_torch_state_dict, variables_shape_tree)
from speaker3d_tpu.models.eres2net import ERes2Net as JaxERes2Net
from speaker3d_tpu_torch.cli import registry as treg
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.eres2net import ERes2Net, eres2net_large
from tests.test_torch_eres2netv2 import assert_close_scaled, jax_variables

SMALL = dict(num_blocks=(2, 2, 1, 1), m_channels=16, feat_dim=80,
             embedding_size=32)
# the registry's three block geometries, m_channels cut to 16 (32 for
# large, twice base's as in the registry)
GEOMETRIES = {"base": dict(base_width=32, scale=2, expansion=2),
              "large": dict(base_width=32, scale=2, expansion=2,
                            m_channels=32, embedding_size=48),
              "huge": dict(base_width=24, scale=3, expansion=4)}


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_small_depth_matches_jax(geom):
    kw = {**SMALL, **GEOMETRIES[geom]}
    jm = JaxERes2Net(**kw)
    variables = jax_variables(jm, t=60, seed=7)
    feats = np.random.default_rng(8).standard_normal((2, 60, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    model = ERes2Net(**kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, kw["embedding_size"])
    assert_close_scaled(out, ref, 3e-4)


def test_kernel_takes_layer1_2_of_scale_2_only():
    """Eval mode sends every scale-2 block without AFF to the Res2 block
    kernel: layer1-2 of base and large (7 blocks at full depth), none of
    huge (scale 3)."""
    for model_id, want in (("iic/speech_eres2net_base_sv_zh-cn_3dspeaker_16k", 7),
                           ("iic/speech_eres2net_large_sv_zh-cn_3dspeaker_16k", 7),
                           ("iic/speech_eres2net_sv_zh-cn_16k-common", 0)):
        model = treg.build_model(model_id)
        fused = [name for name, blk in model.named_modules()
                 if getattr(blk, "fusable", False)]
        assert len(fused) == want, (model_id, fused)
        assert all(n.startswith(("layer1.", "layer2.")) for n in fused)


def test_unported_options_raise():
    """TAP, TSDP and TSTP are the pooling functions the JAX module takes;
    any other name is refused, naming them."""
    with pytest.raises(ValueError, match="TSTP"):
        ERes2Net(pooling_func="ASTP")


@pytest.mark.parametrize("pooling_func", ["TAP", "TSDP"])
def test_pooling_and_second_embedding_layer_match_jax(pooling_func):
    kw = {**SMALL, **GEOMETRIES["base"], "pooling_func": pooling_func,
          "two_emb_layer": True}
    jm = JaxERes2Net(**kw)
    variables = jax_variables(jm, t=60, seed=11)
    feats = np.random.default_rng(12).standard_normal((2, 60, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    model = ERes2Net(**kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert "seg_2.weight" in model.state_dict()
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(feats)).numpy()
    assert_close_scaled(out, ref, 3e-4)


def test_large_parameter_count():
    count = sum(p.numel() for p in eres2net_large().parameters()) / 1e6
    assert abs(count - 22.46) < 0.05


# Dense in the JAX modules, Conv1d(k=1) in the reference: CAM++ and ECAPA
CONV1D_K1 = ("xvector.dense.linear.weight", "fc.conv.weight")


@pytest.mark.parametrize("model_id", sorted(jreg.SUPPORTS))
def test_registry_state_dict_matches_jax(model_id):
    """The port's module for each id has the reference's state_dict keys and
    shapes: those the JAX module exports, the JAX ``nn.Dense`` layers that
    are k=1 ``Conv1d``s in the reference compared after that reshape."""
    shapes = variables_shape_tree(jreg.build_model(model_id),
                                  np.zeros((1, 100, 80), np.float32))
    theirs = export_torch_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    ours = {k: tuple(v.shape) for k, v in
            treg.build_model(model_id).state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k] == (v.shape + (1,) if k in CONV1D_K1 else v.shape), k
