"""Kaldi-compatible log-mel filterbank features (PyTorch).

The counterpart of ``speaker3d_tpu/ops/fbank.py``: the same behavioural
contract (``torchaudio.compliance.kaldi.fbank(..., dither=0)`` with
``snip_edges=True``), the same folding of DC removal, pre-emphasis, window
and the padded rDFT into one analysis matrix ``B``, computed in float64 with
numpy and stored as float32 tensors. ``KaldiFbank`` runs the spectral
pipeline through ``ops/kernels/fbank_kernel.py``: the CUDA kernel on the
card (B and mel split and packed for it once, at construction), its plain
version (``Tensor.unfold`` framing) on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from speaker3d_tpu_torch.device import resolve_device
from speaker3d_tpu_torch.ops.kernels import fbank_kernel


def mel_scale(freq):
    """Kaldi mel scale: 1127 * ln(1 + f/700)."""
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def inverse_mel_scale(mel):
    """The frequency of a Kaldi mel value: 700 * (exp(mel / 1127) - 1)."""
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Kaldi FbankOptions / FrameExtractionOptions / MelBanksOptions."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0  # <= 0 means offset from the Nyquist frequency
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman|sine
    blackman_coeff: float = 0.42
    round_to_power_of_two: bool = True
    use_power: bool = True
    use_log_fbank: bool = True
    snip_edges: bool = True

    def __post_init__(self):
        if not self.snip_edges:
            # no framing path implements the reflect-padded framing: reject
            # rather than silently produce snip-edges features
            raise NotImplementedError(
                "snip_edges=False is not implemented (the reference "
                "pipeline uses snip_edges=True throughout)")

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        n = self.frame_length
        if self.round_to_power_of_two:
            p = 1
            while p < n:
                p *= 2
            return p
        return n


def feature_window(cfg: FbankConfig) -> np.ndarray:
    """The analysis window, float64 [frame_length]."""
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    wt = cfg.window_type
    if wt == "rectangular":
        return np.ones(n, dtype=np.float64)
    if wt == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if wt == "sine":
        return np.sin(0.5 * a * i)
    if wt == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if wt == "povey":  # like hanning but goes to zero at edges
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if wt == "blackman":
        bc = cfg.blackman_coeff
        return bc - 0.5 * np.cos(a * i) + (0.5 - bc) * np.cos(2 * a * i)
    raise ValueError(f"unknown window type {wt!r}")


def mel_banks(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, float64 [n_rfft_bins, num_mel_bins]; the
    Nyquist row is zero (Kaldi builds the banks over bins 0..N/2-1)."""
    nfft = cfg.padded_window_size
    num_fft_bins = nfft // 2
    nyquist = 0.5 * cfg.sample_rate
    low_freq = cfg.low_freq
    high_freq = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    if not (0 <= low_freq < high_freq <= nyquist):
        raise ValueError(f"bad frequency range [{low_freq}, {high_freq}]")

    fft_bin_width = cfg.sample_rate / nfft
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)

    bin_mels = mel_scale(np.arange(num_fft_bins, dtype=np.float64) * fft_bin_width)
    m = np.arange(cfg.num_mel_bins, dtype=np.float64)
    left = mel_low + m * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    up = (bin_mels[:, None] - left[None, :]) / mel_delta
    down = (right[None, :] - bin_mels[:, None]) / mel_delta
    weights = np.maximum(0.0, np.minimum(up, down))

    out = np.zeros((num_fft_bins + 1, cfg.num_mel_bins), dtype=np.float64)
    out[:num_fft_bins] = weights
    return out


def analysis_matrix(cfg: FbankConfig) -> np.ndarray:
    """The folded frame-analysis matrix, float64 [frame_length, 2 * n_bins]:
    columns 0..n_bins-1 give the real part of the padded rFFT of the
    DC-removed, pre-emphasized, windowed frame, columns n_bins.. the
    imaginary part (numpy rfft sign convention)."""
    L = cfg.frame_length
    nfft = cfg.padded_window_size
    n_bins = nfft // 2 + 1

    # T = diag(window) @ Preemph @ DCRemoval   (applied as T @ frame)
    T = np.eye(L, dtype=np.float64)
    if cfg.remove_dc_offset:
        T = T - np.full((L, L), 1.0 / L, dtype=np.float64)
    coeff = cfg.preemphasis_coefficient
    if coeff != 0.0:
        P = np.eye(L, dtype=np.float64)
        P[0, 0] = 1.0 - coeff  # Kaldi: x[0] -= coeff * x[0]
        for j in range(1, L):
            P[j, j - 1] = -coeff
        T = P @ T
    T = feature_window(cfg)[:, None] * T

    j = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * j * k / nfft
    return np.concatenate([T.T @ np.cos(ang), T.T @ -np.sin(ang)], axis=1)


class KaldiFbank:
    """Callable Kaldi-fbank frontend on one device.

    >>> fbank = KaldiFbank(FbankConfig(num_mel_bins=80), device="cpu")
    >>> feats = fbank(wav)            # wav [n] or [batch, n] -> [.., T, 80]
    """

    def __init__(self, cfg: FbankConfig = FbankConfig(), mean_norm: bool = False,
                 *, device="cuda"):
        self.cfg = cfg
        self.mean_norm = mean_norm
        self.device = resolve_device(device)
        self._B = torch.as_tensor(analysis_matrix(cfg), dtype=torch.float32,
                                  device=self.device)
        self._mel = torch.as_tensor(mel_banks(cfg), dtype=torch.float32,
                                    device=self.device)
        # the kernel's operands, split and packed once (CUDA only); a config
        # the kernel does not take (a window that is not a power of two of
        # 256-2048 samples, more than 80 mel bins) raises ValueError here
        self._packed = (fbank_kernel.pack_fbank(self._B, self._mel)
                        if self.device.type == "cuda" else None)

    def __call__(self, wav, mean_norm: bool | None = None):
        """wav: float tensor [..., num_samples] on this frontend's device ->
        log-mel [..., num_frames, M]."""
        mean_norm = self.mean_norm if mean_norm is None else mean_norm
        wav = torch.as_tensor(wav, device=self.device)
        lead = wav.shape[:-1]
        feats = fbank_kernel.fbank_features(
            wav.reshape(-1, wav.shape[-1]).to(torch.float32).contiguous(),
            self._B, self._mel, self._packed,
            frame_length=self.cfg.frame_length,
            frame_shift=self.cfg.frame_shift,
            use_power=self.cfg.use_power, use_log=self.cfg.use_log_fbank)
        if mean_norm:
            feats = feats - feats.mean(dim=-2, keepdim=True)
        return feats.reshape(lead + feats.shape[1:])


class FBank:
    """Behavioural equivalent of the reference FBank processor: 80-mel Kaldi
    fbank, optional per-utterance mean normalisation over time, dither=0."""

    def __init__(self, n_mels: int = 80, sample_rate: int = 16000,
                 mean_nor: bool = False, *, device="cuda"):
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.mean_nor = mean_nor
        self._fbank = KaldiFbank(
            FbankConfig(sample_rate=sample_rate, num_mel_bins=n_mels),
            mean_norm=mean_nor, device=device)

    def __call__(self, wav, dither: float = 0.0):
        del dither  # inference path is dither-free, matching the reference
        wav = torch.as_tensor(wav)
        if wav.ndim == 2 and wav.shape[0] == 1:  # [1, n] channel-first mono
            wav = wav[0]
        return self._fbank(wav)
