"""torchaudio-style linear mel spectrogram, the SSL trainers' feature.

The counterpart of ``speaker3d_tpu/ops/melspec.py`` (reference:
``torchaudio.transforms.MelSpectrogram(sample_rate=16000, n_fft=512,
win_length=400, hop_length=160, f_min=0, f_max=8000, n_mels=80)``):
centred reflect padding of ``n_fft / 2``, a periodic Hann window of
``win_length`` samples centred in the ``n_fft`` frame, the power-2
spectrum, an HTK mel scale with no filterbank norm, and no log (the SSL
backbone takes the log and an instance norm itself,
``models/ecapa_tdnn.py``). Output laid out ``[.., frames, n_mels]``.

Not the Kaldi fbank of the fbank kernel: the JAX package computes this
feature with two plain matmuls outside any Pallas kernel, so here it is
two ``torch.matmul``s (framing by ``unfold``, the windowed DFT [n_fft, 2 *
bins], then the mel projection), run in full fp32 with TF32 off for the
call (the JAX package's ``Precision.HIGHEST``) and the flags restored.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@dataclasses.dataclass(frozen=True)
class MelSpecConfig:
    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 0.0
    f_max: float = 8000.0
    n_mels: int = 80
    power: float = 2.0
    center: bool = True


def mel_filterbank(cfg: MelSpecConfig) -> np.ndarray:
    """[n_fft//2+1, n_mels] float64: HTK scale, triangular, no norm
    (torchaudio's defaults)."""
    n_freqs = cfg.n_fft // 2 + 1
    all_freqs = np.linspace(0, cfg.sample_rate // 2, n_freqs)
    m_min, m_max = hz_to_mel_htk(cfg.f_min), hz_to_mel_htk(cfg.f_max)
    m_pts = np.linspace(m_min, m_max, cfg.n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]       # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def window_dft_matrix(cfg: MelSpecConfig) -> np.ndarray:
    """[n_fft, 2*(n_fft//2+1)] float64: the Hann-windowed DFT, real parts
    then imaginary parts. The periodic window over ``win_length`` sits
    centred in the ``n_fft`` frame, as ``torch.stft`` pads it."""
    n = cfg.win_length
    win = 0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n)
    pad_left = (cfg.n_fft - n) // 2
    full_win = np.zeros(cfg.n_fft)
    full_win[pad_left:pad_left + n] = win

    n_bins = cfg.n_fft // 2 + 1
    j = np.arange(cfg.n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * j * k / cfg.n_fft
    d_re = np.cos(ang) * full_win[:, None]
    d_im = -np.sin(ang) * full_win[:, None]
    return np.concatenate([d_re, d_im], axis=1)


class MelSpectrogram(nn.Module):
    """``wav [.., L]`` (or [L]) float32 -> ``[.., 1 + L // hop, n_mels]``
    on ``device``. The DFT and mel matrices are fp32 buffers."""

    def __init__(self, cfg: MelSpecConfig = MelSpecConfig(),
                 device=DEFAULT_DEVICE, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.register_buffer("dft", torch.tensor(
            window_dft_matrix(cfg), dtype=dtype, device=dev),
            persistent=False)
        self.register_buffer("mel", torch.tensor(
            mel_filterbank(cfg), dtype=dtype, device=dev), persistent=False)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lead = wav.shape[:-1]
        x = wav.reshape(-1, wav.shape[-1])
        if cfg.center:
            p = cfg.n_fft // 2
            x = F.pad(x.unsqueeze(1), (p, p), mode="reflect").squeeze(1)
        frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)  # [N, T, n_fft]
        n_bins = self.mel.shape[0]
        with matmul_precision("highest"):
            y = torch.matmul(frames, self.dft)
            spec = torch.square(y[..., :n_bins]) + torch.square(y[..., n_bins:])
            if cfg.power != 2.0:
                spec = torch.pow(torch.clamp(spec, min=0.0), cfg.power / 2.0)
            out = torch.matmul(spec, self.mel)
        return out.reshape(lead + out.shape[1:])
