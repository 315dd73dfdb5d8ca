"""The port's int8 post-training quantization (eval/quant.py) against the
JAX package's ``speaker3d_tpu/eval/quant.py`` on the third model of
tests/test_quant.py, CAM++: its scales against ``traced_scales`` (the JAX
``calibrate_act_scales``'s records in one jitted apply, held to that
function in tests/test_torch_quant.py: the function itself runs CAM++'s 52
dense layers op by op, ~35 s on an 8-core CPU), and its int8 forward at
float32 against ``quantized_apply_fn`` (bfloat16 in
tests/test_torch_quant_campplus_bf16.py), with the checks and tolerances
of tests/test_torch_quant.py and tests/test_torch_quant_int8.py.

The weights start in the port (its init, BatchNorm statistics drawn as
``jax_variables`` draws them: means N(0, 0.1), variances U(0.5, 1.5)) and
cross to the JAX package through ``flax_from_state_dict``, the converter of
the port's trainers: a JAX init of this CAM++ compiles for ~12 s on an
8-core CPU.
"""

import torch

from speaker3d_tpu.models.campplus import CAMPPlus as JaxCAMPPlus
from speaker3d_tpu_torch.compat.flax_convert import flax_from_state_dict
from speaker3d_tpu_torch.models.campplus import CAMPPlus
from tests.test_torch_quant import (
    check_calibration, quant_feats, traced_scales)
from tests.test_torch_quant_int8 import check_int8_forward
from tests.torch_threads import cap_torch_threads  # noqa: F401

KW = dict(feat_dim=80, embedding_size=64, growth_rate=8, init_channels=16)
_CACHE = {}


def campplus_setup():
    """(JAX module, variables, port model, feats), once."""
    if not _CACHE:
        torch.manual_seed(0)
        pm = CAMPPlus(**KW).eval()
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, t in pm.state_dict().items():
                if name.endswith("running_mean"):
                    t.copy_(0.1 * torch.randn(t.shape, generator=gen))
                elif name.endswith("running_var"):
                    t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        variables = flax_from_state_dict(pm.state_dict(), pm.flax_joined_names,
                                         pm.flax_dense_names)
        _CACHE["setup"] = (JaxCAMPPlus(**KW), variables, pm, quant_feats())
    return _CACHE["setup"]


def test_campplus_calibration_matches_jax():
    jm, variables, pm, feats = campplus_setup()
    check_calibration(pm, feats, traced_scales(jm, variables, feats[:2]))


def test_campplus_int8_forward_matches_jax_float32():
    check_int8_forward(*campplus_setup(), "float32")
