"""The PyTorch port's ResNet, Res2Net, x-vector, classifiers and pooling
functions (models/resnet.py, res2net.py, xvector.py, classifier.py,
pooling.py) against the JAX package's.

Weights come from a JAX init with randomised BatchNorm statistics (means
near 0, as ``tests/test_torch_eres2netv2.py::jax_variables`` draws them),
cross over through ``state_dict_from_flax(..., like=...)`` and load with
``strict=True``. Outputs are compared after dividing both by the
reference's largest magnitude, at rtol = atol = 3e-4, at small widths and
depths; at the recipe configs' widths the state_dict keys and shapes equal
those of ``export_torch_state_dict``.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.compat.torch_convert import (
    export_torch_state_dict, variables_shape_tree)
from speaker3d_tpu.models import classifier as jcls
from speaker3d_tpu.models import pooling as jpool
from speaker3d_tpu.models.res2net import Res2Net as JaxRes2Net
from speaker3d_tpu.models.resnet import ResNet as JaxResNet
from speaker3d_tpu.models.xvector import Xvector as JaxXvector
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models import classifier as tcls
from speaker3d_tpu_torch.models import pooling as tpool
from speaker3d_tpu_torch.models.res2net import Res2Net
from speaker3d_tpu_torch.models.resnet import ResNet
from speaker3d_tpu_torch.models.xvector import Xvector
from tests.test_torch_eres2netv2 import assert_close_scaled
from tests.torch_threads import cap_torch_threads  # noqa: F401

TOL = 3e-4
BACKBONES = {
    "resnet": (JaxResNet, ResNet, dict(num_blocks=(2, 1, 1, 1), m_channels=8,
                                       feat_dim=40, embedding_size=24)),
    "resnet_one_emb_tap": (JaxResNet, ResNet, dict(
        num_blocks=(1, 1, 1, 1), m_channels=8, feat_dim=80,
        embedding_size=24, two_emb_layer=False, pooling_func="TAP")),
    "res2net": (JaxRes2Net, Res2Net, dict(num_blocks=(2, 1, 1, 1),
                                          m_channels=8, feat_dim=80,
                                          embedding_size=24)),
    "res2net_s4_two_emb_tsdp": (JaxRes2Net, Res2Net, dict(
        num_blocks=(1, 1, 1, 1), m_channels=16, feat_dim=40,
        embedding_size=24, scale=4, expansion=4, base_width=16,
        two_emb_layer=True, pooling_func="TSDP")),
    "xvector": (JaxXvector, Xvector, dict(feat_dim=40, hid_dim=32,
                                          stats_dim=48, embed_dim=16)),
}
# the recipe configs' model args (configs/resnet.yaml, res2net.yaml,
# xvector.yaml)
RECIPES = {
    "resnet": (JaxResNet, ResNet, dict(feat_dim=80, embedding_size=192,
                                       m_channels=32, two_emb_layer=False)),
    "res2net": (JaxRes2Net, Res2Net, dict(feat_dim=80, embedding_size=192,
                                          m_channels=32)),
    "xvector": (JaxXvector, Xvector, dict(feat_dim=80, embed_dim=512)),
    "resnet34_default": (JaxResNet, ResNet, dict()),
}


def _variables(model, example, seed):
    """JAX init on ``example`` with BN running means drawn near 0 (N(0,
    0.1)) and variances from U(0.5, 1.5), as nested dicts of numpy arrays
    (``tests/test_torch_eres2netv2.py::jax_variables`` at any input)."""
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), example)
    rng = np.random.default_rng(seed + 1)

    def draw(path, v):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    out = {"params": jax.tree_util.tree_map(np.asarray, variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            draw, variables["batch_stats"])
    return out


def _port(cls, variables, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(name):
    jcls_, tcls_, kw = BACKBONES[name]
    jm = jcls_(**kw)
    feat = kw.get("feat_dim", 40)
    feats = np.random.default_rng(4).standard_normal((3, 50, feat)).astype(
        np.float32)
    variables = _variables(jm, feats[:1], seed=3)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    with torch.inference_mode():
        out = _port(tcls_, variables, **kw)(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape
    assert_close_scaled(out, ref, TOL)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_widths_state_dict_matches_jax(name):
    jcls_, tcls_, kw = RECIPES[name]
    feat = kw.get("feat_dim", 40)
    shapes = variables_shape_tree(jcls_(**kw),
                                  np.zeros((1, 100, feat), np.float32))
    theirs = export_torch_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    ours = {k: tuple(v.shape) for k, v in tcls_(**kw).state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k] == v.shape, k


def test_recipe_parameter_counts():
    """The module docstrings' counts: Res2Net 4.03M, x-vector 4.25M at its
    default 40 mel bins and 4.35M at the recipe's 80; ResNet34 at the
    recipe's 80 mel bins 6.31M."""
    count = {name: sum(p.numel() for p in cls(**kw).parameters()) / 1e6
             for name, (_, cls, kw) in RECIPES.items()}
    assert abs(count["res2net"] - 4.03) < 0.005
    assert abs(count["xvector"] - 4.35) < 0.005
    assert abs(sum(p.numel() for p in Xvector().parameters()) / 1e6
               - 4.25) < 0.005
    assert abs(count["resnet"] - 6.31) < 0.005


@pytest.mark.parametrize("name", ["TAP", "TSDP", "TSTP"])
@pytest.mark.parametrize("ndim", [3, 4])
def test_pooling_functions_match_jax(name, ndim):
    """The port takes the reference's [B, C, T] / [B, C, F, T]; the JAX
    functions take channels-last [B, T, C] / [B, F, T, C]."""
    rng = np.random.default_rng(ndim)
    x = rng.standard_normal((2, 6, 5, 11) if ndim == 4 else (2, 6, 11)
                            ).astype(np.float32)
    jx = x.transpose(0, 2, 3, 1) if ndim == 4 else x.transpose(0, 2, 1)
    want = np.asarray(jpool.POOLING_FUNCS[name](jx))
    got = tpool.POOLING_FUNCS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    mult = tpool.pooling_output_mult(name)
    assert mult == jpool.pooling_output_mult(name)
    assert got.shape[1] == mult * (30 if ndim == 4 else 6)


def test_unknown_pooling_is_refused():
    with pytest.raises(ValueError, match="TSTP"):
        ResNet(pooling_func="ASTP")


@pytest.mark.parametrize("global_context_att", [False, True])
@pytest.mark.parametrize("ndim", [3, 4])
def test_astp_matches_jax(global_context_att, ndim):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 4, 9) if ndim == 4 else (2, 24, 9)
                            ).astype(np.float32)
    jx = x.transpose(0, 2, 3, 1) if ndim == 4 else x.transpose(0, 2, 1)
    jm = jpool.ASTP(bottleneck_dim=8, global_context_att=global_context_att)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), jx))
    want = np.asarray(jm.apply(variables, jx))
    model = tpool.ASTP(24, bottleneck_dim=8,
                       global_context_att=global_context_att)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["CosineClassifier", "LinearClassifier"])
@pytest.mark.parametrize("num_blocks", [0, 2])
def test_classifier_matches_jax(kind, num_blocks):
    kw = dict(input_dim=16, num_blocks=num_blocks, inter_dim=12,
              out_neurons=10)
    x = np.random.default_rng(num_blocks).standard_normal((5, 16)).astype(
        np.float32)
    jm = getattr(jcls, kind)(**kw)
    variables = _variables(jm, x, seed=num_blocks)
    want = np.asarray(jm.apply(variables, x))
    model = getattr(tcls, kind)(**kw)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (5, 10)
    assert_close_scaled(got, want, TOL)
    theirs = export_torch_state_dict(variables)
    ours = model.state_dict()
    assert {k for k in ours if not k.endswith("num_batches_tracked")} == set(
        theirs)
    for k, v in theirs.items():  # JAX Dense [O, I] = the reference's [O, I, 1]
        assert tuple(ours[k].shape) in (v.shape, v.shape + (1,)), k
