"""MFCC features with python_speech_features semantics (TalkNet's audio
input).

The counterpart of ``speaker3d_tpu/ops/mfcc.py``, copied as it is:
``python_speech_features.mfcc(audio, 16000, numcep=13, winlen, winstep)``
as the ASD data and the video diarization CLI use it: whole-signal
pre-emphasis 0.97, a rectangular window, a zero-padded last frame (the
frame count rounds up), |rfft|^2 / NFFT power spectrum, 26 HTK-mel filters
over [0, nyquist], log, DCT-II (ortho) -> 13 coefficients, ceplifter 22,
c0 replaced by the log of the frame's total energy. The frame length and
step round half up, as the library's decimal rounding does.

Host numpy in float64, with ``scipy.fft.dct``; the output is bit-equal to
the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.fft import dct


def _hz2mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel2hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _filterbank(nfilt, nfft, rate, lowfreq=0.0, highfreq=None):
    highfreq = highfreq or rate / 2
    mel_pts = np.linspace(_hz2mel(lowfreq), _hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(mel_pts) / rate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fbank


def mfcc(signal, samplerate=16000, winlen=0.025, winstep=0.01, numcep=13,
         nfilt=26, nfft=512, preemph=0.97, ceplifter=22, append_energy=True):
    """signal: 1-D array (int16 or float) -> [num_frames, numcep] float."""
    signal = np.asarray(signal, dtype=np.float64).reshape(-1)
    # whole-signal pre-emphasis (psf.sigproc.preemphasis)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    # psf uses decimal ROUND_HALF_UP; python round() is banker's rounding
    # (0.025*44100=1102.5 -> 1102), which diverges at non-16k rates
    frame_len = int(math.floor(winlen * samplerate + 0.5))
    frame_step = int(math.floor(winstep * samplerate + 0.5))
    n = len(signal)
    if n <= frame_len:
        num_frames = 1
    else:
        num_frames = 1 + int(np.ceil((n - frame_len) / frame_step))
    pad_len = (num_frames - 1) * frame_step + frame_len
    padded = np.concatenate([signal, np.zeros(max(0, pad_len - n))])

    idx = (np.tile(np.arange(frame_len), (num_frames, 1))
           + np.tile(np.arange(0, num_frames * frame_step, frame_step),
                     (frame_len, 1)).T)
    frames = padded[idx]

    pspec = np.square(np.abs(np.fft.rfft(frames, nfft, axis=1))) / nfft
    energy = np.sum(pspec, axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)

    fb = _filterbank(nfilt, nfft, samplerate)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat)

    feat = dct(feat, type=2, axis=1, norm="ortho")[:, :numcep]
    if ceplifter > 0:
        ncoeff = feat.shape[1]
        lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * np.arange(ncoeff)
                                              / ceplifter)
        feat = feat * lift
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat
