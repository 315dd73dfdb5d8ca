"""The 3xTF32 operands and numerics of the port's fbank kernel, on the CPU.

``fbank_kernel.pack_fbank`` splits and packs B (its bins 0..255, columns
interleaved as (re_k, im_k)) and mel (rows 0..255) into the B fragments that
csrc/fbank.cu multiplies on the tensor cores. The kernel's products are
emulated here from those packed operands, with the frames and the power
split as the kernel splits them in registers, and held against the JAX
package's Pallas kernel in interpret mode at the Kaldi-oracle thresholds of
tests/test_fbank_ref_oracle.py. One TF32 pass in either product fails them,
which is why the kernel runs three. tests/test_torch_gpu.py holds the
kernel itself against the plain version on the card.
"""

import numpy as np
import pytest
import torch

from speaker3d_tpu.ops import fbank as jfbank
from speaker3d_tpu.ops.pallas.fbank_kernel import pallas_fbank
from speaker3d_tpu_torch.ops import fbank as tfbank
from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
from speaker3d_tpu_torch.ops.kernels.tf32 import tf32_split
from tests.test_torch_res2_tf32 import _unpack_b
from tests.torch_threads import cap_torch_threads  # noqa: F401

FS = 16000
NB = 256


def _waves(seed: int, batch: int, n: int, fs: int = FS) -> np.ndarray:
    """Two-tone waves with noise, quantised to k/32768 as PCM16 audio is."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0 = rng.uniform(100, 400, size=(batch, 1))
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3.1 * f0 * t + 0.5)
    wav += 0.02 * rng.standard_normal((batch, n))
    return (np.round(wav * 32768) / 32768).astype(np.float32)


def _unpack_parts(packed):
    """(big, small) K-major matrices of a ``pack_b`` result."""
    big = _unpack_b(torch.cat([packed[..., :2], 0 * packed[..., 2:]], dim=-1))
    small = _unpack_b(torch.cat([0 * packed[..., :2], packed[..., 2:]], dim=-1))
    return big, small


def _product(a, b_big, b_small, passes: int):
    """a @ b as the kernel forms it, in float64: 3xTF32 (a split in
    registers, the small cross terms first) or one TF32 pass."""
    a_big, a_small = tf32_split(a)
    a_big, a_small = a_big.double(), a_small.double()
    b_big, b_small = b_big.double(), b_small.double()
    if passes == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulate(wav, packed, cfg, dft_passes=3, mel_passes=3):
    """The kernel's function on [batch, n] from the packed operands."""
    L, S = cfg.frame_length, cfg.frame_shift
    kp = packed.dft.shape[0] * 8
    frames = torch.from_numpy(wav).unfold(-1, L, S)
    frames = torch.nn.functional.pad(frames, (0, kp - L))  # zero weights there
    y = _product(frames, *_unpack_parts(packed.dft), dft_passes)
    power = (y[..., 0::2].square() + y[..., 1::2].square()).float()
    mel_big, mel_small = _unpack_parts(packed.mel)
    feats = _product(power, mel_big[:, :packed.n_mel],
                     mel_small[:, :packed.n_mel], mel_passes)
    return torch.log(torch.clamp(feats, min=fk._EPSILON)).float().numpy()


def _oracle_errors(got, want):
    """(strong bins, all bins, mean) |got - want|, as the oracle test has
    them: strong bins lie within 8 nats of their frame's peak."""
    diff = np.abs(got - want)
    strong = want > want.max(axis=-1, keepdims=True) - 8.0
    return diff[strong].max(), diff.max(), diff.mean()


def _meets_oracle(got, want) -> bool:
    strong, every, mean = _oracle_errors(got, want)
    return strong < 5e-4 and every < 2e-2 and mean < 1e-3


@pytest.fixture(scope="module")
def operands():
    cfg = tfbank.FbankConfig()
    fb = tfbank.KaldiFbank(cfg, device="cpu")
    return cfg, fb, fk.pack_fbank(fb._B, fb._mel)


@pytest.mark.parametrize("kw", [{}, {"window_type": "hamming",
                                     "num_mel_bins": 40}])
def test_packed_operands_unpack_to_the_matrices(kw):
    cfg = tfbank.FbankConfig(**kw)
    B = tfbank.analysis_matrix(cfg)
    mel = tfbank.mel_banks(cfg)
    packed = fk.pack_fbank(torch.as_tensor(B, dtype=torch.float32),
                           torch.as_tensor(mel, dtype=torch.float32))
    assert packed.dft.shape == (50, 64, 32, 4)
    assert packed.mel.shape == (32, -(-cfg.num_mel_bins // 8), 32, 4)
    assert packed.n_mel == cfg.num_mel_bins
    dft = _unpack_b(packed.dft).double().numpy()
    assert dft.shape == (400, 512)
    # interleaved: column 2k the real part of bin k, 2k + 1 its imaginary
    B32 = B.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(dft[:, 0::2], B32[:, :NB], rtol=2.0 ** -21,
                               atol=2.0 ** -21 * np.abs(B32).max())
    np.testing.assert_allclose(dft[:, 1::2], B32[:, NB + 1:2 * NB + 1],
                               rtol=2.0 ** -21,
                               atol=2.0 ** -21 * np.abs(B32).max())
    m = _unpack_b(packed.mel).double().numpy()
    np.testing.assert_allclose(m[:, :cfg.num_mel_bins],
                               mel[:NB].astype(np.float32), rtol=2.0 ** -21,
                               atol=0)
    assert not m[:, cfg.num_mel_bins:].any()


@pytest.mark.parametrize("n", [24000, 48000])  # 1.5 s and 3 s chunks
def test_3xtf32_emulation_matches_pallas(operands, n):
    cfg, _, packed = operands
    wav = _waves(n, 4, n)
    want = np.asarray(pallas_fbank(wav, interpret=True))
    got = _emulate(wav, packed, cfg)
    assert got.shape == want.shape == (4, 1 + (n - 400) // 160, 80)
    assert _meets_oracle(got, want), _oracle_errors(got, want)


def test_3xtf32_emulation_matches_pallas_at_8khz():
    """The 10 s chunk at 8 kHz: 200-sample frames at stride 80, 128 bins
    (B's 25 k-steps x 32 n-tiles, mel's 16 k-steps)."""
    jcfg = jfbank.FbankConfig(sample_rate=8000)
    cfg = tfbank.FbankConfig(sample_rate=8000)
    fb = tfbank.KaldiFbank(cfg, device="cpu")
    packed = fk.pack_fbank(fb._B, fb._mel)
    assert packed.dft.shape == (25, 32, 32, 4)
    assert packed.mel.shape == (16, 10, 32, 4)
    wav = _waves(8, 4, 80000, fs=8000)
    want = np.asarray(pallas_fbank(wav, jcfg, interpret=True))
    got = _emulate(wav, packed, cfg)
    assert got.shape == want.shape == (4, 998, 80)
    assert _meets_oracle(got, want), _oracle_errors(got, want)


@pytest.mark.parametrize("dft_passes,mel_passes", [(1, 3), (3, 1)])
def test_one_tf32_pass_in_either_product_fails(operands, dft_passes,
                                               mel_passes):
    cfg, _, packed = operands
    wav = _waves(24000, 4, 24000)
    want = np.asarray(pallas_fbank(wav, interpret=True))
    got = _emulate(wav, packed, cfg, dft_passes, mel_passes)
    assert not _meets_oracle(got, want), _oracle_errors(got, want)


def test_fbank_features_takes_the_plain_version_on_the_cpu(operands):
    cfg, fb, packed = operands
    assert fb._packed is None  # packed only for a CUDA frontend
    wav = torch.from_numpy(_waves(1, 2, 8000))
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
    launches = fk.fbank_features.launches
    got = fk.fbank_features(wav, fb._B, fb._mel, packed, **kw)
    assert fk.fbank_features.launches == launches
    torch.testing.assert_close(got, fk.fbank_plain(wav, fb._B, fb._mel, **kw),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        fk.fbank_features(wav.to("meta"), fb._B, fb._mel, packed, **kw)


def test_fbank_cuda_refuses_a_cpu_tensor(operands):
    cfg, _, packed = operands
    with pytest.raises(ValueError):
        fk.fbank_cuda(torch.zeros((1, 4000)), packed,
                      frame_length=cfg.frame_length,
                      frame_shift=cfg.frame_shift)


def test_pack_fbank_refuses_what_the_kernel_does_not_take(operands):
    _, fb, _ = operands
    bad = fb._mel.clone()
    bad[-1, 3] = 0.5  # a non-zero Nyquist row
    with pytest.raises(ValueError):
        fk.pack_fbank(fb._B, bad)
    wide = torch.zeros((257, 96))  # more mel bins than the kernel holds
    with pytest.raises(ValueError):
        fk.pack_fbank(fb._B, wide)
