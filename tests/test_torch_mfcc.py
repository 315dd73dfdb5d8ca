"""The port's MFCC (``speaker3d_tpu_torch/ops/mfcc.py``) against the JAX
package's on the CPU: bit-equal output over a hypothesis sweep of lengths
at 16 kHz and 44.1 kHz (where the ROUND_HALF_UP frame length differs from
Python's rounding), with the ASD loader's window and hop scaled by 25 /
fps, and on int16 input."""

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from speaker3d_tpu.ops import mfcc as jmfcc
from speaker3d_tpu_torch.ops import mfcc as tmfcc
from tests.torch_threads import cap_torch_threads  # noqa: F401


def _signal(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 24000), rate=st.sampled_from([16000, 44100]),
       seed=st.integers(0, 2**16))
@example(n=400, rate=16000, seed=0)    # exactly one frame
@example(n=1103, rate=44100, seed=1)   # 0.025 * 44100 = 1102.5 rounds up
@example(n=1, rate=16000, seed=2)
def test_mfcc_bit_equal(n, rate, seed):
    x = _signal(n, seed)
    _bit_equal(tmfcc.mfcc(x, rate), jmfcc.mfcc(x, rate))


@pytest.mark.parametrize("fps", [25.0, 30.0, 12.5])
def test_mfcc_at_the_asd_window(fps):
    """The ASD loader's call: window and hop scaled by 25 / fps."""
    x = _signal(16000 * 3 + 123, 5)
    kw = dict(numcep=13, winlen=0.025 * 25 / fps, winstep=0.010 * 25 / fps)
    _bit_equal(tmfcc.mfcc(x, 16000, **kw), jmfcc.mfcc(x, 16000, **kw))


def test_mfcc_on_int16_and_silence():
    pcm = (np.random.default_rng(3).standard_normal(9000) * 3000).astype(
        np.int16)
    _bit_equal(tmfcc.mfcc(pcm), jmfcc.mfcc(pcm))
    zeros = np.zeros(4000, np.float32)  # eps floors in energy and the mels
    got = tmfcc.mfcc(zeros)
    _bit_equal(got, jmfcc.mfcc(zeros))
    assert np.isfinite(got).all() and got.shape == (24, 13)
