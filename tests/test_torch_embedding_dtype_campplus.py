"""CAM++'s bf16 embed call against the JAX package's, as
tests/test_torch_embedding_dtype.py holds the other backbones, with the
weights of tests/test_torch_quant_campplus.py (the port's init carried to
the JAX package: a JAX init of CAM++ compiles for ~12 s on an 8-core CPU,
its bf16 embed call for ~25 s).
"""

from speaker3d_tpu_torch.models.campplus import CAMPPlus
from tests.test_torch_embedding_dtype import check_bf16_embedding
from tests.test_torch_quant_campplus import KW, campplus_setup
from tests.torch_threads import cap_torch_threads  # noqa: F401


def test_campplus_bf16_embedding_matches_jax():
    jm, variables, _, _ = campplus_setup()
    check_bf16_embedding(jm, variables, CAMPPlus(**KW))
