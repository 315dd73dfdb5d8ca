"""The PyTorch port's ECAPA-TDNN (models/ecapa_tdnn.py) against the JAX
package's.

Weights come from a JAX init with randomised BatchNorm statistics
(``tests/test_torch_eres2netv2.py::jax_variables``), cross over through
``state_dict_from_flax`` with the port module's state_dict as ``like`` (the
JAX ``nn.Dense`` of ``fc.conv`` is a k=1 ``Conv1d`` in the port) and load
with ``strict=True``. Embeddings are compared after dividing both by the
reference's largest magnitude, at rtol = atol = 3e-4.
"""

import jax
import numpy as np
import pytest
import torch

from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models.ecapa_tdnn import SBConv1d as JaxSBConv1d
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN, SBConv1d
from tests.test_torch_eres2netv2 import assert_close_scaled, jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

SMALL = dict(input_size=80, lin_neurons=32, channels=(64, 64, 64, 64, 192),
             attention_channels=32, se_channels=16)


def port_ecapa(variables, **kw):
    model = ECAPA_TDNN(**kw)
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("global_context", [True, False])
def test_matches_jax(global_context):
    kw = {**SMALL, "global_context": global_context}
    jm = JaxECAPA(**kw)
    variables = jax_variables(jm, t=60, seed=9)
    feats = np.random.default_rng(10).standard_normal((2, 137, 80)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    with torch.inference_mode():
        out = port_ecapa(variables, **kw)(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, 32)
    assert_close_scaled(out, ref, 3e-4)


@pytest.mark.parametrize("k,d", [(5, 1), (3, 2), (3, 3), (4, 1), (2, 3)])
def test_same_padding_is_reflect_split_like_jax(k, d):
    """Reflect padding, total // 2 before and the rest after (even totals
    too)."""
    x = np.random.default_rng(k * 10 + d).standard_normal((1, 23, 3)).astype(
        np.float32)
    jm = JaxSBConv1d(4, k, d)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jm.apply(variables, x))
    conv = SBConv1d(3, 4, k, d)
    conv.load_state_dict(state_dict_from_flax(variables))
    with torch.inference_mode():
        got = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ssl_input_norm_refused_naming_m12():
    """The SSL variant (M12) is no longer refused: on a linear-mel input
    (log, then the detached instance norm over time) it matches the JAX
    one."""
    kw = {**SMALL, "ssl_input_norm": True}
    jm = JaxECAPA(**kw)
    variables = jax_variables(jm, t=60, seed=11)
    feats = np.exp(2.0 * np.random.default_rng(12).standard_normal(
        (2, 101, 80))).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, feats))
    with torch.inference_mode():
        out = port_ecapa(variables, **kw)(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (2, 32)
    assert_close_scaled(out, ref, 3e-4)


def test_registry_width_parameter_count():
    model = ECAPA_TDNN(channels=(1024, 1024, 1024, 1024, 3072))
    assert abs(sum(p.numel() for p in model.parameters()) / 1e6 - 20.77) < 0.05
