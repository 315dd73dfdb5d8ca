"""The port's int8 post-training quantization (eval/quant.py) against the JAX
package's ``speaker3d_tpu/eval/quant.py``: calibration here, on two of the
three models of tests/test_quant.py, a small ERes2NetV2 (whose Res2 blocks
run K2 in eval mode) and ECAPA-TDNN; their int8 forwards in
tests/test_torch_quant_int8.py and test_torch_quant_eres2netv2.py; CAM++
in tests/test_torch_quant_campplus*.py.

Weights come from a JAX init with randomised BatchNorm statistics
(``tests/test_torch_eres2netv2.py::jax_variables``), carried across by
``state_dict_from_flax``. Calibration keys map to the JAX interceptor's
(``"/".join(module.path)``) through the Flax submodule names
(``compat/flax_convert.py``): the two packages must record the same set of
modules, with the same max-abs inputs to 1e-5 relative (fp32 forwards that
sum in different orders). ``traced_scales`` records what the JAX
``calibrate_act_scales`` records in one jitted apply (the JAX function runs
op by op: ~35 s for CAM++'s 52 dense layers on an 8-core CPU, twice that in
a full run); it is held to the JAX function on both models in this file and
stands in for it on CAM++.

"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as nn_torch

from speaker3d_tpu.eval.quant import calibrate_act_scales as jax_calibrate
from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.compat.flax_convert import (
    _flax_module_path, state_dict_from_flax)
from speaker3d_tpu_torch.eval import quant
from speaker3d_tpu_torch.models import eres2netv2 as port_v2
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from tests.test_torch_eres2netv2 import jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

NO_EXCESS = {"xla_allow_excess_precision": False}
# the configurations of tests/test_quant.py
MODELS = {
    "eres2netv2": (JaxERes2NetV2, port_v2.ERes2NetV2,
                   dict(feat_dim=80, embedding_size=64, m_channels=16)),
    "ecapa": (JaxECAPA, ECAPA_TDNN,
              dict(channels=(64, 64, 64, 64, 192), lin_neurons=32,
                   attention_channels=32)),
}
SCALE_RTOL = 1e-5


def _cosine(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def jax_key(model, name: str) -> str:
    """The JAX interceptor's key of the port module ``name``."""
    joined = getattr(model, "flax_joined_names", ())
    return "/".join(_flax_module_path(name.split("."), joined))


def quant_feats() -> np.ndarray:
    """4 x 1 s of seeded noise through the JAX fbank (tests/test_quant.py
    draws 2 s)."""
    wavs = (np.random.default_rng(0).standard_normal((4, 16000)) * 0.1
            ).astype(np.float32)
    return np.asarray(KaldiFbank(FbankConfig(), mean_norm=True)(wavs))


_CACHE = {}


def _setup(which):
    """(JAX module, variables, port model, feats [4, T, 80]), once per
    model."""
    if which not in _CACHE:
        jcls, pcls, kw = MODELS[which]
        jm = jcls(**kw)
        feats = quant_feats()
        variables = jax_variables(jm, t=feats.shape[1])
        pm = pcls(**kw)
        pm.load_state_dict(state_dict_from_flax(
            variables, like=pm.state_dict()), strict=True)
        _CACHE[which] = (jm, variables, pm.eval(), feats)
    return _CACHE[which]


def traced_scales(jm, variables, feats) -> dict:
    """The JAX ``calibrate_act_scales``'s records (the largest input
    magnitude of every ``nn.Conv`` and ``nn.Dense`` call, in fp32, keyed by
    ``"/".join(module.path)``, the largest over a module's calls) taken in
    one jitted apply of the JAX module."""

    def apply(variables, feats):
        records = {}

        def recorder(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, (nn.Conv, nn.Dense)) and args:
                key = "/".join(str(p) for p in mod.path)
                v = jnp.max(jnp.abs(args[0].astype(jnp.float32)))
                records[key] = (jnp.maximum(records[key], v) if key in records
                                else v)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(recorder):
            jm.apply(variables, feats, train=False)
        return records

    return {k: float(v) for k, v in jax.jit(apply)(variables, feats).items()}


def port_scales(pm, feats) -> dict:
    """The port's scales calibrated on ``feats[:2]``, once per model."""
    if not hasattr(pm, "_test_scales"):
        pm._test_scales = quant.calibrate_act_scales(
            pm, torch.from_numpy(feats[:2]))
    return pm._test_scales


def check_calibration(pm, feats, want):
    """The port's scales on two batches of ``feats`` against ``want`` (the
    JAX package's, under its keys): the same modules, the same values."""
    got = port_scales(pm, feats)
    mapped = {jax_key(pm, name): v for name, v in got.items()}
    assert len(mapped) == len(got) > 5
    assert set(mapped) == set(want)
    for key, v in want.items():
        assert abs(mapped[key] - v) <= SCALE_RTOL * v, (key, mapped[key], v)
    assert pm.training is False and all(
        b.use_kernel for b in pm.modules() if hasattr(b, "use_kernel"))


@pytest.mark.parametrize("which", sorted(MODELS))
def test_calibration_matches_jax(which):
    jm, variables, pm, feats = _setup(which)
    want = jax_calibrate(jm, variables, feats[:2])
    check_calibration(pm, feats, want)
    traced = traced_scales(jm, variables, feats[:2])
    assert set(traced) == set(want)
    for key, v in want.items():
        assert abs(traced[key] - v) <= 1e-6 * v, (key, traced[key], v)


def test_int8_path_launches_no_res2_kernel(monkeypatch):
    """The quantized ERes2NetV2 runs every Res2 block's convs (in int8):
    ``res2_block`` is never called, where the float model calls it for
    every layer1-2 block; the caller's model keeps its kernel."""
    _, _, pm, feats = _setup("eres2netv2")
    calls = []
    real = port_v2.res2_block
    monkeypatch.setattr(port_v2, "res2_block",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.from_numpy(feats[:1])
    with torch.inference_mode():
        pm(x)
    fused = sum(b.fusable for b in (*pm.layer1, *pm.layer2))
    assert fused == 7 and len(calls) == fused
    scales = quant.calibrate_act_scales(pm, x)
    assert len(calls) == fused  # calibration runs the convs
    apply = quant.quantized_apply_fn(pm, scales)
    apply(x)
    assert len(calls) == fused
    assert not any(b.use_kernel for b in apply.model.modules()
                   if hasattr(b, "use_kernel"))
    assert all(b.use_kernel for b in pm.modules() if hasattr(b, "use_kernel"))
    assert next(pm.parameters()).dtype == torch.float32


def test_int8_leaves_grouped_and_unscaled_modules_float():
    """Grouped convs and modules without a (positive) scale keep their float
    forward, as the JAX package's interceptor does."""
    model = nn_torch.Sequential(nn_torch.Conv1d(8, 8, 3, padding=1, groups=4),
                                nn_torch.Conv1d(8, 16, 1),
                                nn_torch.Conv1d(16, 8, 1))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 30)).astype(np.float32))
    scales = quant.calibrate_act_scales(model, x)
    assert set(scales) == {"0", "1", "2"}
    scales["2"] = 0.0
    apply = quant.quantized_apply_fn(model, scales,
                                     compute_dtype=torch.float32)
    q = apply.model
    assert "forward" not in vars(q[0]) and "forward" not in vars(q[2])
    assert "forward" in vars(q[1])
    with torch.inference_mode():
        want = model(x)
    cos = torch.nn.functional.cosine_similarity(apply(x).flatten(1),
                                                want.flatten(1), dim=1)
    assert float(cos.min()) > 0.999
