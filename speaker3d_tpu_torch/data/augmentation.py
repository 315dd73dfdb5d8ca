"""Waveform augmentation: additive noise at a random SNR, RIR reverb.

The counterpart of ``speaker3d_tpu/data/augmentation.py`` (host numpy and
scipy, float32 throughout). Every random draw comes from the
``random.Random`` the caller passes, in the JAX package's order, so one
seeded generator draws what the JAX package's seeded global ``random``
draws.
"""

from __future__ import annotations

import random

import numpy as np
from scipy import signal

from speaker3d_tpu_torch.utils.fileio import load_wav_scp, read_wav


def addreverb(wav: np.ndarray, rir_wav: np.ndarray) -> np.ndarray:
    """Energy-normalised RIR, full convolution cut to the input's length,
    peak-normalised output."""
    wav = np.asarray(wav, dtype=np.float32)
    rir = np.asarray(rir_wav, dtype=np.float32)
    rir = rir / np.sqrt(np.sum(rir ** 2))
    out = signal.convolve(wav, rir, mode="full")[: wav.shape[0]]
    out = out / (np.max(np.abs(out)) + 1e-6)
    return out.astype(np.float32)


def addnoise(wav: np.ndarray, noise: np.ndarray, snr_high=15, snr_low=0, *,
             rng: random.Random) -> np.ndarray:
    """Noise cropped (or sample-held, the reference's ``ndarray.repeat``) to
    the input's length at an SNR drawn from [snr_low, snr_high] dB,
    peak-normalised output."""
    wav = np.asarray(wav, dtype=np.float32)
    noise = np.asarray(noise, dtype=np.float32)
    wav_len, noise_len = wav.shape[0], noise.shape[0]
    if noise_len >= wav_len:
        start = rng.randint(0, noise_len - wav_len)
        noise = noise[start:start + wav_len]
    else:
        # element-wise repetition (sample-and-hold), not np.tile, as the
        # reference's ndarray.repeat
        k = wav_len // noise_len + 1
        noise = np.ascontiguousarray(
            np.broadcast_to(noise[:, None], (noise_len, k))).reshape(-1)
        noise = noise[:wav_len]
    wav_db = 10 * np.log10(np.mean(wav ** 2) + 1e-6)
    noise_db = 10 * np.log10(np.mean(noise ** 2) + 1e-6)
    snr = rng.uniform(snr_low, snr_high)
    noise = np.sqrt(10 ** ((wav_db - noise_db - snr) / 10)) * noise
    out = wav + noise
    out = out / (np.max(np.abs(out)) + 1e-6)
    return out.astype(np.float32)


class NoiseReverbCorrupter:
    """wav.scp-driven noise and RIR pools with independent probabilities."""

    def __init__(self, noise_prob=0.0, reverb_prob=0.0, noise_file=None,
                 reverb_file=None, noise_snr_low=0, noise_snr_high=15, *,
                 rng: random.Random):
        if reverb_prob > 0.0:
            if reverb_file is None:
                raise ValueError("reverb_file must be assigned.")
            self.reverb_data = load_wav_scp(reverb_file)
            self.reverb_keys = list(self.reverb_data.keys())
        if noise_prob > 0.0:
            if noise_file is None:
                raise ValueError("noise_file must be assigned.")
            self.noise_data = load_wav_scp(noise_file)
            self.noise_keys = list(self.noise_data.keys())
        self.reverb_prob = reverb_prob
        self.noise_prob = noise_prob
        self.noise_snr_low = noise_snr_low
        self.noise_snr_high = noise_snr_high
        self.rng = rng

    def __call__(self, wav, fs=16000):
        rng = self.rng
        if self.reverb_prob > rng.random():
            rir, fs_rir = read_wav(self.reverb_data[rng.choice(self.reverb_keys)])
            if fs_rir != fs:
                raise ValueError(f"RIR at {fs_rir} Hz, expected {fs}")
            wav = addreverb(wav, rir[0])
        if self.noise_prob > rng.random():
            noise, fs_noise = read_wav(self.noise_data[rng.choice(self.noise_keys)])
            if fs_noise != fs:
                raise ValueError(f"noise at {fs_noise} Hz, expected {fs}")
            wav = addnoise(wav, noise[0], snr_high=self.noise_snr_high,
                           snr_low=self.noise_snr_low, rng=rng)
        return wav
