"""``build_embedding_fn(..., dtype=torch.bfloat16)`` of the port
(eval/embedding.py) against the JAX package's ``build_embedding_fn`` with
bf16-cast variables and ``dtype=jnp.bfloat16`` (as bench.py and
tools/bench_diarization.py call it), on small ERes2NetV2 (its layer1-2
blocks through the Res2 block's bf16 plain version on the CPU, K2's bf16
variant on the card), ERes2Net and ECAPA-TDNN (CAM++ in
tests/test_torch_embedding_dtype_campplus.py: its bf16 embed call compiles
for ~25 s on an 8-core CPU), and against the port's own fp32 path at
bench.py's 0.999 gate.

The JAX side is compiled with ``xla_allow_excess_precision`` off, so that it
rounds every bf16 op's output as the port does. The two still differ where
they round differently:

- the Res2 blocks: the JAX function runs the unfused module (each conv's
  and each BatchNorm's output rounded to bf16), the port the BN-folded
  block, which rounds where the TPU kernel does (tests/test_torch_res2_bf16.py
  holds it against that kernel);
- sigmoid and softmax (CAM++'s context mask, ECAPA's squeeze-excitation and
  attention): XLA on the CPU expands them into bf16 steps (exp, add, divide,
  each rounded), torch computes them in fp32 and rounds once;
- every sum, in its own order, flips the rounding of a value that lies near
  a bf16 boundary now and then, and a flip spreads through the layers after
  it (tests/test_torch_sv_train.py measured the same on random trunks).

So the embeddings are held at cosine (measured on the CPU: ERes2NetV2 0.99996,
ERes2Net 0.99998, ECAPA 0.99998, CAM++ 0.999998), and the bf16 path against
the port's fp32 path at bench.py's 0.999 (measured 0.99995 and up: these
small random models allow the gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.eval.embedding import build_embedding_fn as jax_embedding_fn
from speaker3d_tpu.models.ecapa_tdnn import ECAPA_TDNN as JaxECAPA
from speaker3d_tpu.models.eres2net import ERes2Net as JaxERes2Net
from speaker3d_tpu.models.eres2netv2 import ERes2NetV2 as JaxERes2NetV2
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
from speaker3d_tpu_torch.models.eres2net import ERes2Net
from speaker3d_tpu_torch.models.eres2netv2 import ERes2NetV2
from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
from tests.test_torch_eres2netv2 import SMALL, jax_variables
from tests.torch_threads import cap_torch_threads  # noqa: F401

NO_EXCESS = {"xla_allow_excess_precision": False}
MODELS = {
    "eres2netv2": (JaxERes2NetV2, ERes2NetV2, SMALL),
    "eres2net": (JaxERes2Net, ERes2Net, SMALL),
    "ecapa": (JaxECAPA, ECAPA_TDNN,
              dict(channels=(64, 64, 64, 64, 192), lin_neurons=32,
                   attention_channels=32)),
}
JAX_COS = 0.9999     # port bf16 against JAX bf16 (measured >= 0.99996)
BENCH_GATE = 0.999   # bench.py's bf16 gate against fp32


def _cosine(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def check_bf16_embedding(jm, variables, model):
    """The port's bf16 embed call on ``model`` (loaded with ``variables``)
    against the JAX one, and against the port's fp32 call."""
    wavs = (np.random.default_rng(1).standard_normal((3, 16000)) * 0.1
            ).astype(np.float32)
    bf16 = jax.tree_util.tree_map(
        lambda v: v.astype(jnp.bfloat16) if v.dtype == np.float32 else v,
        variables)
    fn = jax_embedding_fn(jm, bf16, dtype=jnp.bfloat16)
    want = np.asarray(fn.lower(wavs).compile(NO_EXCESS)(wavs))
    model.load_state_dict(state_dict_from_flax(variables,
                                               like=model.state_dict()),
                          strict=True)
    fp32 = build_embedding_fn(model, device="cpu")(wavs).numpy()
    launches = (rk.res2_block.launches, rk.res2_block.launches_bf16)
    got = build_embedding_fn(model, device="cpu", dtype=torch.bfloat16)(wavs)
    assert (rk.res2_block.launches, rk.res2_block.launches_bf16) == launches
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    got = got.numpy()
    assert _cosine(got, want).min() > JAX_COS, _cosine(got, want)
    assert _cosine(got, fp32).min() > BENCH_GATE, _cosine(got, fp32)


@pytest.mark.parametrize("which", sorted(MODELS))
def test_bf16_embedding_matches_jax(which):
    jcls, pcls, kw = MODELS[which]
    jm = jcls(**kw)
    check_bf16_embedding(jm, jax_variables(jm, t=98), pcls(**kw))


def test_bf16_embedding_folds_per_dtype():
    """One model, fp32 then bf16: the Res2 blocks fold once per dtype, and
    the cast drops the fp32 fold (its weights are gone)."""
    model = ERes2NetV2(**SMALL)
    wavs = (np.random.default_rng(2).standard_normal((2, 8000)) * 0.1
            ).astype(np.float32)
    build_embedding_fn(model, device="cpu")(wavs)
    block = model.layer1[0]
    assert list(block._folds) == [(torch.device("cpu"), torch.float32)]
    build_embedding_fn(model, device="cpu", dtype=torch.bfloat16)(wavs)
    assert list(block._folds) == [(torch.device("cpu"), torch.bfloat16)]
    assert block.folded(torch.bfloat16).dtype == torch.bfloat16
