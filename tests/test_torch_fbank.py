"""The PyTorch port's Kaldi fbank (ops/fbank.py, ops/kernels/fbank_kernel.py)
against the JAX package's XLA frontend, its Pallas kernel (interpret mode) and
the reference C++ oracle frozen in tests/data/golden_fbank_ref.npz.

On the CPU the port runs the kernel's plain version (the wrapper launches the
CUDA kernel only for a CUDA tensor); tests/test_torch_gpu.py holds the CUDA
kernel against it on the card.
"""

import os

import numpy as np
import pytest
import torch

from speaker3d_tpu.ops import fbank as jfbank
from speaker3d_tpu.ops.pallas.fbank_kernel import pallas_fbank
from speaker3d_tpu_torch.ops import fbank as tfbank
from speaker3d_tpu_torch.ops.kernels import fbank_kernel
from tests.torch_threads import cap_torch_threads  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_fbank_ref.npz")


def _port(wav, mean_norm=False):
    fb = tfbank.KaldiFbank(tfbank.FbankConfig(), mean_norm=mean_norm,
                           device="cpu")
    return fb(torch.from_numpy(wav)).numpy()


def test_matrices_equal_jax():
    for kw in ({}, {"window_type": "hamming", "num_mel_bins": 40}):
        jc, tc = jfbank.FbankConfig(**kw), tfbank.FbankConfig(**kw)
        np.testing.assert_array_equal(tfbank.analysis_matrix(tc),
                                      jfbank.analysis_matrix(jc))
        np.testing.assert_array_equal(tfbank.mel_banks(tc),
                                      jfbank.mel_banks(jc))
        np.testing.assert_array_equal(tfbank.feature_window(tc),
                                      jfbank.feature_window(jc))
    with pytest.raises(NotImplementedError):
        tfbank.FbankConfig(snip_edges=False)


def test_batch_matches_jax_and_pallas():
    rng = np.random.default_rng(0)
    wavs = (rng.standard_normal((2, 48000)) * 0.1).astype(np.float32)
    launches = fbank_kernel.fbank_features.launches
    out = _port(wavs)
    assert fbank_kernel.fbank_features.launches == launches  # CPU: plain
    ref = np.asarray(jfbank.KaldiFbank(jfbank.FbankConfig())(wavs))
    pal = np.asarray(pallas_fbank(wavs, interpret=True))
    assert out.shape == ref.shape == (2, 298, 80)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-4)


def test_1d_and_mean_norm_match_jax_and_pallas():
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    out = _port(wav, mean_norm=True)
    ref = np.asarray(jfbank.KaldiFbank(jfbank.FbankConfig(), mean_norm=True)(wav))
    pal = np.asarray(pallas_fbank(wav, mean_norm=True, interpret=True))
    assert out.shape == ref.shape == (98, 80)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, pal, rtol=1e-4, atol=1e-4)
    # FBank processor: [1, n] channel-first mono, mean_nor
    fb = tfbank.FBank(mean_nor=True, device="cpu")
    np.testing.assert_allclose(fb(torch.from_numpy(wav[None])).numpy(), out,
                               rtol=0, atol=0)


def test_shorter_than_one_frame_gives_zero_frames():
    out = _port(np.zeros((3, 399), np.float32))
    assert out.shape == (3, 0, 80)


def test_matches_reference_cpp_oracle():
    """Thresholds of tests/test_fbank_ref_oracle.py: bins within 8 nats of
    the frame's peak to 5e-4, every bin to 2e-2, mean |diff| below 1e-3."""
    golden = np.load(GOLDEN)
    for name in ["tone_440", "harmonics", "white_noise", "am_chirp", "quiet",
                 "tone_noise"]:
        wav = golden["wav_" + name].astype(np.float32) / 32767.0
        got = _port(wav[None])[0]
        want = golden["fbank_" + name]
        assert got.shape == want.shape, name
        diff = np.abs(got - want)
        strong = want > want.max(axis=1, keepdims=True) - 8.0
        assert diff[strong].max() < 5e-4, (name, diff[strong].max())
        assert diff.max() < 2e-2, (name, diff.max())
        assert diff.mean() < 1e-3, (name, diff.mean())


def test_kernel_needs_zero_nyquist_mel_row():
    fbank_kernel.check_mel_for_kernel(tfbank.mel_banks(tfbank.FbankConfig()))
    bad = tfbank.mel_banks(tfbank.FbankConfig())
    bad[-1, 3] = 0.5
    with pytest.raises(ValueError):
        fbank_kernel.check_mel_for_kernel(bad)


@pytest.mark.parametrize("rate,frames,n_bins", [(8000, 98, 128),
                                                (48000, 98, 1024)])
def test_other_rates_match_jax(rate, frames, n_bins):
    """8 kHz (200-sample frames, a 256-point rDFT) and 48 kHz (1200, 2048):
    the windows K1 takes besides 16 kHz."""
    kw = dict(sample_rate=rate, num_mel_bins=80)
    wav = (np.random.default_rng(rate).standard_normal((2, rate))
           * 0.1).astype(np.float32)
    fb = tfbank.KaldiFbank(tfbank.FbankConfig(**kw), mean_norm=True,
                           device="cpu")
    out = fb(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jfbank.KaldiFbank(jfbank.FbankConfig(**kw),
                                       mean_norm=True)(wav))
    assert out.shape == ref.shape == (2, frames, 80)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert fbank_kernel.check_mel_for_kernel(fb._mel) == n_bins
    packed = fbank_kernel.pack_fbank(fb._B, fb._mel)
    assert packed.n_bins == n_bins
    assert packed.dft.shape == (-(-fb.cfg.frame_length // 8), n_bins // 4,
                                32, 4)
    assert packed.mel.shape == (n_bins // 8, 10, 32, 4)


@pytest.mark.parametrize("kw,limit", [
    ({"round_to_power_of_two": False}, "power-of-two padded window"),
    ({"sample_rate": 4000}, "power-of-two padded window"),     # 64 bins
    ({"sample_rate": 96000}, "power-of-two padded window"),    # 2048 bins
    ({"num_mel_bins": 96}, "at most 80 mel bins")])
def test_kernel_refuses_what_it_cannot_take_naming_the_limit(kw, limit):
    cfg = tfbank.FbankConfig(**kw)
    mel = torch.as_tensor(tfbank.mel_banks(cfg), dtype=torch.float32)
    B = torch.as_tensor(tfbank.analysis_matrix(cfg), dtype=torch.float32)
    with pytest.raises(ValueError, match=limit):
        fbank_kernel.pack_fbank(B, mel)
    # the CPU frontend still computes it (the plain version takes any window)
    out = tfbank.KaldiFbank(cfg, device="cpu")(torch.zeros(cfg.sample_rate))
    assert out.shape == (98, cfg.num_mel_bins)
