"""Int8 forwards of the port (eval/quant.py) against the JAX package's
``quantized_apply_fn``: one quantized layer of each kind, and whole
ECAPA-TDNN forwards at ``compute_dtype`` float32 and bfloat16
(tests/test_torch_quant.py's model and weights). The same whole-forward
check runs on the small ERes2NetV2 in tests/test_torch_quant_eres2netv2.py
and on CAM++ in tests/test_torch_quant_campplus*.py (a file each: in a
full run's load each JAX trace and compile takes 10-30 s).

One quantized Conv or Dense, given the same input, gives the same output in
both packages (the int8 products are exact, the float epilogue the same
ops). A whole int8 forward is held at cosine: an activation that lies within
float noise of a half int8 step rounds one way in one package and the other
way in the other, and the step then propagates through the layers after it
(measured, with both packages at the port's scales: ECAPA 1.0 in float32 and
0.99994 in bfloat16, CAM++ 1.0 and 0.999996, the 16-block ERes2NetV2
0.99982 and 0.99974; int8 against the fp32 forward lies 0.99957-0.99999
away). Each int8 forward is also held at the JAX test's own 0.99 cosine
against the fp32 forward.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as nn_torch

from speaker3d_tpu.eval.quant import quantized_apply_fn as jax_quantized
from speaker3d_tpu_torch.eval import quant
from tests.test_torch_quant import (
    NO_EXCESS, _cosine, _setup, jax_key, port_scales)
from tests.torch_threads import cap_torch_threads  # noqa: F401

INT8_COS = 0.9995   # port against JAX, whole forwards (measured >= 0.99974)


def int8_forwards(jm, variables, pm, feats, dtype):
    """The port's and the JAX package's int8 embeddings of ``feats[2:]`` in
    ``dtype``, both at the port's scales calibrated on ``feats[:2]`` (the
    JAX ones under their keys), and the port's fp32 forward."""
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    scales = port_scales(pm, feats)
    x = feats[2:]
    fn = jax.jit(jax_quantized(
        jm, variables, {jax_key(pm, k): v for k, v in scales.items()},
        compute_dtype=jdtype))
    want = np.asarray(fn.lower(x).compile(NO_EXCESS)(x).astype(jnp.float32))
    got = quant.quantized_apply_fn(pm, scales, compute_dtype=tdtype)(
        torch.from_numpy(x))
    assert got.dtype == tdtype
    with torch.inference_mode():
        ref = pm(torch.from_numpy(x)).numpy()
    return got.float().numpy(), want, ref


def check_int8_forward(jm, variables, pm, feats, dtype):
    got, want, ref = int8_forwards(jm, variables, pm, feats, dtype)
    assert _cosine(got, want).min() > INT8_COS, _cosine(got, want)
    assert _cosine(ref, got).min() > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(dtype):
    check_int8_forward(*_setup("ecapa"), dtype)


class _One(nn.Module):
    """One Flax Conv (or Dense) named ``layer``, as a model for the JAX
    interceptor (``train`` taken and ignored)."""

    kind: str
    kw: dict

    @nn.compact
    def __call__(self, x, train: bool = False):
        cls = nn.Conv if self.kind == "conv" else nn.Dense
        return cls(name="layer", **self.kw)(x)


# (Flax layer, its port counterpart, the port input's shape): 3x3 stride
# (2, 1) pad 1 with a bias, a dilated 1-D conv, a k=1 1-D conv without a
# bias, and a Dense over the last axis of a 3-D input
ONE_LAYERS = [
    ("conv", dict(features=12, kernel_size=(3, 3), strides=(2, 1),
                  padding=((1, 1), (1, 1))),
     nn_torch.Conv2d(6, 12, 3, stride=(2, 1), padding=1), (2, 6, 9, 14)),
    ("conv", dict(features=16, kernel_size=(3,), kernel_dilation=(2,),
                  padding=((2, 2),)),
     nn_torch.Conv1d(8, 16, 3, dilation=2, padding=2), (2, 8, 30)),
    ("conv", dict(features=10, kernel_size=(1,), use_bias=False),
     nn_torch.Conv1d(8, 10, 1, bias=False), (3, 8, 5)),
    ("dense", dict(features=7), nn_torch.Linear(20, 7), (2, 3, 20)),
]


@pytest.mark.parametrize("case", range(len(ONE_LAYERS)))
def test_one_int8_layer_equals_jax(case):
    """Given the same input, one quantized layer equals the JAX package's to
    float32 rounding: the int32 sums are exact, the epilogue the same."""
    kind, kw, layer, shape = ONE_LAYERS[case]
    torch.manual_seed(case)
    x = torch.randn(shape)
    w = layer.weight.detach()
    kernel = (w.permute(*range(2, w.ndim), 1, 0) if kind == "conv"
              else w.t()).numpy()
    params = {"kernel": kernel}
    if layer.bias is not None:
        params["bias"] = layer.bias.detach().numpy()
    jm = _One(kind, kw)
    xj = (x.permute(0, *range(2, x.ndim), 1) if kind == "conv" else x).numpy()
    scale = float(x.abs().max())
    want = np.asarray(jax_quantized(jm, {"params": {"layer": params}},
                                    {"layer": scale},
                                    compute_dtype=jnp.float32)(xj))
    model = nn_torch.Sequential(layer).eval()
    got = quant.quantized_apply_fn(model, {"0": scale},
                                   compute_dtype=torch.float32)(x)
    if kind == "conv":
        got = got.permute(0, *range(2, got.ndim), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
