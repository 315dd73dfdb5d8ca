"""The port's SAN-M encoder, LFR stacking and CTC model against the JAX
package's.

The same seeded inputs and weights (a JAX init with every leaf redrawn
from a seeded normal, biases and LayerNorm scales included) go through
``speaker3d_tpu.models.sanm`` / ``asr.ctc`` and their port through
``state_dict_from_flax``; the forwards agree at atol 1e-5 (measured: at
most ~2e-6 at d_model 32). LFR stacking and the position encoding are
exact. ``flax_from_state_dict`` writes SAN-M's dotted Flax names
(``feed_forward.w_1``), so the round trip gives the JAX tree back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.asr import ctc as jctc
from speaker3d_tpu.data.processor_para import apply_lfr_device as j_lfr
from speaker3d_tpu.models import sanm as jsanm
from speaker3d_tpu_torch.asr import ctc as tctc
from speaker3d_tpu_torch.compat.flax_convert import (
    flax_from_state_dict, state_dict_from_flax)
from speaker3d_tpu_torch.data.processor_para import apply_lfr_device as t_lfr
from speaker3d_tpu_torch.models import sanm as tsanm
from tests.torch_threads import cap_torch_threads  # noqa: F401

ATOL = 1e-5


def _redrawn(variables, seed):
    """Every leaf of a Flax tree redrawn from a seeded normal (scale 0.3),
    LayerNorm scales around 1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = 0.3 * rng.standard_normal(leaf.shape).astype(np.float32)
        if path[-1].key == "scale":
            x = 1.0 + x
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def _feats(b, t, d, seed):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


@pytest.mark.parametrize("t,depth", [(1, 4), (7, 40), (150, 400), (33, 32)])
def test_sinusoidal_pe_equal(t, depth):
    np.testing.assert_array_equal(tsanm.funasr_sinusoidal_pe(t, depth),
                                  jsanm.funasr_sinusoidal_pe(t, depth))


def test_sinusoidal_pe_refuses_odd_depth():
    with pytest.raises(ValueError, match="even depth"):
        tsanm.funasr_sinusoidal_pe(4, 5)


@pytest.mark.parametrize("t,lfr_m,lfr_n", [
    (20, 5, 4), (21, 7, 6), (3, 5, 4), (1, 7, 6), (9, 1, 1), (10, 3, 1),
    (16, 4, 4), (150, 5, 4)])
def test_lfr_equal(t, lfr_m, lfr_n):
    x = _feats(2, t, 6, seed=t + lfr_m)
    got = t_lfr(torch.from_numpy(x), lfr_m, lfr_n).numpy()
    want = np.asarray(j_lfr(jnp.asarray(x), lfr_m, lfr_n))
    assert got.shape == want.shape == (2, -(-t // lfr_n), lfr_m * 6)
    np.testing.assert_array_equal(got, want)


ENCODERS = {
    # name: (input_dim, d_model, heads, ffn, layers, kernel, T)
    "odd_kernel": (40, 32, 2, 64, 3, 7, 23),
    "even_kernel": (40, 32, 4, 48, 2, 4, 17),
    "square_first_block": (32, 32, 2, 64, 2, 11, 9),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_forward_equal(name):
    din, d, h, ffn, layers, k, t = ENCODERS[name]
    jm = jsanm.SANMEncoder(input_dim=din, d_model=d, num_heads=h,
                           ffn_dim=ffn, num_layers=layers, kernel_size=k)
    x = _feats(2, t, din, seed=1)
    variables = _redrawn(jm.init(jax.random.PRNGKey(0), x), seed=2)
    want = np.asarray(jm.apply(variables, x))
    tm = tsanm.SANMEncoder(input_dim=din, d_model=d, num_heads=h,
                           ffn_dim=ffn, num_layers=layers, kernel_size=k)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert tm.encoders0[0].residual == (din == d)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def ctc_pair():
    kw = dict(vocab_size=5, feat_dim=16, d_model=32, num_heads=2, ffn_dim=64,
              num_layers=2, kernel_size=7, lfr_m=5, lfr_n=4)
    jm = jctc.SANMCTC(**kw)
    x = _feats(2, 61, 16, seed=3)
    variables = jm.init(jax.random.PRNGKey(1), x)
    return jm, tctc.SANMCTC(**kw), variables, x


def test_ctc_forward_equal(ctc_pair):
    jm, tm, variables, x = ctc_pair
    variables = _redrawn(variables, seed=4)
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = np.asarray(jm.apply(variables, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_flax_round_trip_keeps_dotted_names(ctc_pair):
    _, tm, variables, _ = ctc_pair
    back = flax_from_state_dict(state_dict_from_flax(variables),
                                tm.flax_joined_names)
    assert "feed_forward.w_1" in back["params"]["encoder"]["encoders0.0"]
    assert "feed_forward.w_2" in back["params"]["encoder"]["encoders.0"]
    paths = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in paths]
    for (_, a), (_, b) in zip(got, paths):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_initial_weights_follow_flax(ctc_pair):
    """Zero biases but the blank prior, LayerNorm 1 / 0, lecun-normal
    kernels (std over fan-in as Flax's init draws them)."""
    jm, _, variables, _ = ctc_pair
    tm = tctc.init_sanm_ctc_(tctc.SANMCTC(
        vocab_size=5, feat_dim=16, d_model=32, num_heads=2, ffn_dim=64,
        num_layers=2, kernel_size=7), torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    want = state_dict_from_flax(variables)
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        w = want[k].numpy()
        if k.endswith("bias") or "norm" in k:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
        else:
            assert v.std().item() == pytest.approx(float(w.std()), rel=0.35), k
    assert sd["ctc_out.bias"][tctc.BLANK_ID] == 2.0
