"""The FSMN VAD and segmenter of the PyTorch package against the JAX
package's Flax modules on the CPU: the same Flax init through both (weights
carried by ``compat/flax_convert.py`` both ways), logits at atol 1e-5, at a
small size and at the full widths of configs/fsmn_vad.yaml and
configs/fsmn_seg.yaml; ``pit_bce`` on a hypothesis sweep of K in 1-4; the
Flax -> port -> Flax round trip bit-equal; the port's initialiser draws
Flax's default distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from speaker3d_tpu.models import fsmn_vad as jvad
from speaker3d_tpu.models import segmentation as jseg
from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.models import fsmn_vad as tvad
from speaker3d_tpu_torch.models import segmentation as tseg
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(feat_dim=80, hidden_dim=32, proj_dim=16, num_layers=2,
             lorder=6, rorder=3)


def _config_args(name):
    with open(f"configs/{name}.yaml") as f:
        config = yaml.safe_load(f)
    args = dict(config["model"]["args"])
    if "max_speakers" in config:
        args["max_speakers"] = config["max_speakers"]
    return args


CASES = [("vad", SMALL), ("seg", dict(SMALL, max_speakers=3)),
         ("vad", _config_args("fsmn_vad")), ("seg", _config_args("fsmn_seg"))]


def _pair(kind, args, x, seed=0):
    jcls, tcls = ((jvad.FSMNVad, tvad.FSMNVad) if kind == "vad"
                  else (jseg.FSMNSegmenter, tseg.FSMNSegmenter))
    jmodel, tmodel = jcls(**args), tcls(**args)
    variables = jmodel.init(jax.random.PRNGKey(seed), x[:1])
    # move biases and norms off their zero / one init
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (
            0 if path[-1].key == "kernel" else 0.1 * rng.standard_normal(
                a.shape).astype(np.float32)), jax.device_get(variables))
    tmodel.load_state_dict(state_dict_from_flax(
        variables, like=tmodel.state_dict()), strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("kind,args", CASES,
                         ids=["vad-small", "seg-small", "vad-config",
                              "seg-config"])
def test_logits_equal_flax(kind, args):
    rng = np.random.default_rng(1)
    # log-mel-like features: a level per window and bin, frame noise
    x = (rng.uniform(-12.0, 2.0, (2, 1, 80))
         + rng.standard_normal((2, 230, 80))).astype(np.float32)
    jmodel, variables, tmodel = _pair(kind, args, x)
    want = np.asarray(jmodel.apply(variables, x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert tmodel.receptive_field == jmodel.receptive_field
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,args", CASES[:2], ids=["vad", "seg"])
def test_flax_round_trip_bit_equal(kind, args):
    x = np.zeros((1, 40, 80), np.float32)
    _, variables, tmodel = _pair(kind, args, x, seed=3)
    back = flax_from_state_dict(tmodel.state_dict())
    assert set(back) == {"params"}
    flat_want = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    flat_got = jax.tree_util.tree_flatten_with_path(back["params"])[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    # the memory kernel: Flax [k, 1, C] <-> torch depthwise [C, 1, k]
    assert tuple(tmodel.fsmn[0].memory.weight.shape) == (
        args["proj_dim"], 1, args["lorder"] + args["rorder"] + 1)


@settings(max_examples=12, deadline=None)
@given(k=st.integers(1, 4), b=st.integers(1, 3), t=st.sampled_from([1, 7, 12]),
       seed=st.integers(0, 2**31 - 1))
def test_pit_bce_equal_jax(k, b, t, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, t, k))).astype(np.float32)
    labels = (rng.random((b, t, k)) < 0.4).astype(np.int32)
    want_loss, want_perm = jseg.pit_bce(jnp.asarray(logits),
                                        jnp.asarray(labels))
    got_loss, got_perm = tseg.pit_bce(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               rtol=0, atol=1e-6)
    assert np.array_equal(got_perm.numpy(), np.asarray(want_perm))


def test_lecun_init_draws_flax_defaults():
    """The port's initialiser: zero biases, LayerNorm 1 / 0, kernels with
    the fan-in standard deviation of Flax's lecun_normal, truncated at two
    of them, reproducible from the generator's seed."""
    args = _config_args("fsmn_vad")
    model = tvad.lecun_init_(tvad.FSMNVad(**args),
                             torch.Generator().manual_seed(0))
    again = tvad.lecun_init_(tvad.FSMNVad(**args),
                             torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(p, q), name
    variables = jax.device_get(jvad.FSMNVad(**args).init(
        jax.random.PRNGKey(0), np.zeros((1, 8, 80), np.float32)))
    want = state_dict_from_flax(variables, like=model.state_dict())
    for name, p in model.state_dict().items():
        w = want[name]
        if name.endswith("bias") or name == "in_norm.weight":
            assert torch.equal(p, w), name
            continue
        fan_in = p.shape[1] * (p.shape[2] if p.ndim == 3 else 1)
        std = (1.0 / fan_in) ** 0.5
        assert float(p.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
        # both draws' spread agrees with lecun_normal's (a 4-sigma band on
        # the sample standard deviation, plus 2%)
        n = p.numel()
        for a in (p, w):
            assert abs(float(a.std()) / std - 1.0) < 4 / (2 * n) ** 0.5 + 0.02, name
