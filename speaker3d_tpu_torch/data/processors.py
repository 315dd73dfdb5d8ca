"""Host data processors: wav reading and cropping with speed perturbation,
speaker label encoding, augmentation choice.

The counterpart of ``speaker3d_tpu/data/processors.py``:
  - ``WavReader``: load, check the rate, draw a speed of 1.0/0.9/1.1 (each
    a class set of its own downstream), a random fixed-length crop, zero-pad
    short utterances. A perturbed crop is resampled over its receptive
    field only (``data/resample.py``), its start drawn over the resampled
    length, as resampling first would.
  - ``SpkLabelEncoder``: speaker -> id in CSV order; a speed index s maps
    to ``id + n_speakers * s``.
  - ``SpkVeriAug``: with probability ``aug_prob`` one of noise, reverb, or
    both.
Every random draw comes from the ``random.Random`` the caller passes, in the
JAX package's order: seeded as the JAX CLI seeds the global ``random``, one
worker draws the same crops, speeds and augmentations.
"""

from __future__ import annotations

import pickle
import random

import numpy as np

from speaker3d_tpu_torch.data.augmentation import NoiseReverbCorrupter
from speaker3d_tpu_torch.data.resample import (
    out_len, resample_poly_segment, speed_ratio)
from speaker3d_tpu_torch.utils.fileio import load_data_csv, read_wav

SPEEDS = (1.0, 0.9, 1.1)


def speed_perturb(wav: np.ndarray, speed: float, sample_rate: int = 16000):
    """sox `speed S`: resample by 1/S, played at the original rate."""
    if speed == 1.0:
        return wav
    num, den = speed_ratio(speed)
    return resample_poly_segment(wav, num, den, 0, out_len(len(wav), num, den))


class WavReader:
    def __init__(self, sample_rate=16000, duration: float = 3.0,
                 speed_pertub: bool = False, lm: bool = True, *,
                 rng: random.Random):
        self.sample_rate = sample_rate
        self.duration = duration
        self.speed_pertub = speed_pertub
        self.lm = lm
        self.rng = rng

    def __call__(self, wav_path):
        wav, sr = read_wav(wav_path)
        if sr != self.sample_rate:
            raise ValueError(f"{wav_path}: {sr} Hz, expected {self.sample_rate}")
        wav = wav[0]
        speed_idx = (self.rng.randint(0, 2)
                     if self.speed_pertub and self.lm else 0)
        chunk_len = int(self.duration * sr)
        if speed_idx > 0:
            num, den = speed_ratio(SPEEDS[speed_idx])
            data_len = out_len(wav.shape[0], num, den)
            if data_len >= chunk_len:
                start = self.rng.randint(0, data_len - chunk_len)
                wav = resample_poly_segment(wav, num, den, start, chunk_len)
            else:
                wav = resample_poly_segment(wav, num, den, 0, data_len)
                wav = np.pad(wav, (0, chunk_len - data_len))
            return wav.astype(np.float32), speed_idx
        data_len = wav.shape[0]
        if data_len >= chunk_len:
            start = self.rng.randint(0, data_len - chunk_len)
            wav = wav[start:start + chunk_len]
        else:
            wav = np.pad(wav, (0, chunk_len - data_len))
        return wav.astype(np.float32), speed_idx


class SpkLabelEncoder:
    def __init__(self, data_file=None):
        self.lab2ind = {}
        self.ind2lab = {}
        self.starting_index = -1
        if data_file is not None:
            self.load_from_csv(data_file)

    def __call__(self, spk, speed_idx=0):
        return self.lab2ind[spk] + len(self.lab2ind) * speed_idx

    def load_from_csv(self, path):
        self.data = load_data_csv(path)
        for key in self.data:
            self.add(self.data[key]["spk"])

    def add(self, label):
        if label in self.lab2ind:
            return
        self.starting_index += 1
        self.lab2ind[label] = self.starting_index
        self.ind2lab[self.starting_index] = label

    def __len__(self):
        return len(self.lab2ind)

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.lab2ind, f)

    def load(self, path):
        with open(path, "rb") as f:
            self.lab2ind = pickle.load(f)
        self.ind2lab = {v: k for k, v in self.lab2ind.items()}


class SpkVeriAug:
    def __init__(self, aug_prob: float = 0.0, noise_file=None,
                 reverb_file=None, *, rng: random.Random):
        self.aug_prob = aug_prob
        self.rng = rng
        if aug_prob > 0:
            self.augmentations = [
                NoiseReverbCorrupter(noise_prob=1.0, noise_file=noise_file,
                                     rng=rng),
                NoiseReverbCorrupter(reverb_prob=1.0, reverb_file=reverb_file,
                                     rng=rng),
                NoiseReverbCorrupter(noise_prob=1.0, reverb_prob=1.0,
                                     noise_file=noise_file,
                                     reverb_file=reverb_file, rng=rng),
            ]

    def __call__(self, wav):
        if self.aug_prob > self.rng.random():
            return self.rng.choice(self.augmentations)(wav, 16000)
        return wav
