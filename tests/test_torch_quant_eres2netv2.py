"""The small ERes2NetV2's int8 forwards (the Res2 kernel off in every
block) in float32 and bfloat16 against the JAX package's
``quantized_apply_fn``, with the weights of tests/test_torch_quant.py and
the check and tolerance of tests/test_torch_quant_int8.py.
"""

import pytest

from tests.test_torch_quant import _setup
from tests.test_torch_quant_int8 import check_int8_forward
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eres2netv2_int8_forward_matches_jax(dtype):
    check_int8_forward(*_setup("eres2netv2"), dtype)
