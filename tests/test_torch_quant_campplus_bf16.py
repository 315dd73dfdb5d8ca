"""CAM++'s int8 forward at ``compute_dtype`` bfloat16 against the JAX
package's ``quantized_apply_fn``, with the weights of
tests/test_torch_quant_campplus.py (which holds its float32 forward and its
calibration) and the check of tests/test_torch_quant_int8.py.
"""

from tests.test_torch_quant_campplus import campplus_setup
from tests.test_torch_quant_int8 import check_int8_forward
from tests.torch_threads import cap_torch_threads  # noqa: F401


def test_campplus_int8_forward_matches_jax_bfloat16():
    check_int8_forward(*campplus_setup(), "bfloat16")
