"""The port's linear mel spectrogram (ops/melspec.py) against the JAX
package's: the filterbank and windowed-DFT matrices at 1e-12, and
``MelSpectrogram`` on [4, 64000] and [8, 32000] (the SSL trainers' global
and local crop lengths) and on a 1-D waveform within 1e-5 of max|want|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker3d_tpu.ops import melspec as jmel
from speaker3d_tpu_torch.ops import melspec
from tests.torch_threads import cap_torch_threads  # noqa: F401


@pytest.mark.parametrize("kw", [{}, {"n_mels": 64}, {"sample_rate": 8000,
                                                     "f_max": 4000.0,
                                                     "n_fft": 256,
                                                     "win_length": 200}])
def test_matrices_equal_jax(kw):
    cfg, jcfg = melspec.MelSpecConfig(**kw), jmel.MelSpecConfig(**kw)
    np.testing.assert_allclose(melspec.mel_filterbank(cfg),
                               jmel.mel_filterbank(jcfg), rtol=0, atol=1e-12)
    np.testing.assert_allclose(melspec.window_dft_matrix(cfg),
                               jmel.window_dft_matrix(jcfg), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 64000), (8, 32000), (3000,)])
def test_melspectrogram_matches_jax(shape):
    wav = (0.1 * np.random.default_rng(len(shape) * 7 + shape[-1] % 97)
           .standard_normal(shape)).astype(np.float32)
    want = np.asarray(jmel.MelSpectrogram()(jnp.asarray(wav)))
    got = melspec.MelSpectrogram(device="cpu")(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == shape[:-1] + (1 + shape[-1] // 160, 80)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_melspectrogram_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")  # pragma: no cover
    with pytest.raises(RuntimeError, match="cpu"):
        melspec.MelSpectrogram()
