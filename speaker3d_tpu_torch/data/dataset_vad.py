"""Synthetic-mixture dataset for VAD training (host numpy).

The counterpart of ``speaker3d_tpu/data/dataset_vad.py``, copied: the same
``default_rng((seed, index))`` draws give byte-equal items. Each example is
a fixed-length window: a background bed (a noise-corpus crop when given,
else shaped Gaussian noise at a random level) plus 0..max_events speech
crops at random positions and SNRs; the per-frame labels follow placement.
Speech utterances with long internal silences yield noisy positive labels:
prefer trimmed speech.

Emits (wav [L] float32, labels [T] int32) with T the Kaldi snip-edges frame
count of L, the frames of the fbank inside the train step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from speaker3d_tpu_torch.utils.fileio import load_audio, load_data_csv, load_wav_scp


def _load_source_list(path: str) -> List[str]:
    """A CSV with a 'wav' column, a wav.scp, or a plain list of paths."""
    if path.endswith(".csv"):
        data = load_data_csv(path)
        return [row["wav"] for row in data.values()]
    try:
        entries = load_wav_scp(path)
        if entries:
            return list(entries.values())
    except ValueError:
        pass  # single-column file: plain list of paths
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def frame_labels(intervals: Sequence[tuple], num_samples: int,
                 frame_length: int = 400, frame_shift: int = 160) -> np.ndarray:
    """Per-frame speech labels from sample intervals: a frame is speech iff
    its center falls inside a speech interval (snip-edges framing)."""
    if num_samples < frame_length:
        return np.zeros((0,), np.int32)
    t = 1 + (num_samples - frame_length) // frame_shift
    centers = np.arange(t) * frame_shift + frame_length // 2
    lab = np.zeros(t, np.int32)
    for s, e in intervals:
        lab |= ((centers >= s) & (centers < e)).astype(np.int32)
    return lab


class SyntheticVadDataset:
    """Map-style dataset of synthetic speech/background mixtures."""

    def __init__(self, speech: str, noise: Optional[str] = None,
                 sample_rate: int = 16000, window_dur: float = 4.0,
                 max_events: int = 3, min_event_dur: float = 0.4,
                 snr_range: tuple = (0.0, 20.0), seed: int = 0,
                 size: Optional[int] = None,
                 frame_length: int = 400, frame_shift: int = 160):
        self.speech = _load_source_list(speech)
        if not self.speech:
            raise ValueError(f"no speech sources in {speech}")
        self.noise = _load_source_list(noise) if noise else []
        self.fs = sample_rate
        self.win = int(window_dur * sample_rate)
        self.max_events = max_events
        self.min_event = int(min_event_dur * sample_rate)
        self.snr_range = snr_range
        self.seed = seed
        self.size = size if size is not None else max(len(self.speech) * 4, 64)
        self.frame_length = frame_length
        self.frame_shift = frame_shift

    def __len__(self):
        return self.size

    def _crop(self, wav: np.ndarray, length: int, rng) -> np.ndarray:
        if len(wav) <= length:
            reps = -(-length // max(len(wav), 1))
            wav = np.tile(wav, reps)
        start = int(rng.integers(0, len(wav) - length + 1))
        return wav[start:start + length]

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        # background bed
        if self.noise:
            src = load_audio(self.noise[int(rng.integers(len(self.noise)))],
                             obj_fs=self.fs)
            bed = self._crop(np.asarray(src, np.float32).reshape(-1),
                             self.win, rng)
            bed = bed * float(rng.uniform(0.3, 1.0))
        else:
            bed = rng.standard_normal(self.win).astype(np.float32) * float(
                10 ** rng.uniform(-4.0, -2.0))
        if rng.random() < 0.08:
            bed = np.zeros_like(bed)  # digital silence happens in the wild
        out = bed.copy()
        intervals = []
        n_events = int(rng.integers(0, self.max_events + 1))
        for _ in range(n_events):
            src = load_audio(self.speech[int(rng.integers(len(self.speech)))],
                             obj_fs=self.fs)
            src = np.asarray(src, np.float32).reshape(-1)
            dur = int(rng.integers(self.min_event,
                                   max(self.win // 2, self.min_event) + 1))
            seg = self._crop(src, dur, rng)
            pos = int(rng.integers(0, self.win - dur + 1))
            # scale to a random SNR vs the bed
            sp = float(np.sqrt(np.mean(seg ** 2) + 1e-12))
            bp = float(np.sqrt(np.mean(bed ** 2) + 1e-12))
            snr = float(rng.uniform(*self.snr_range))
            gain = bp / sp * 10 ** (snr / 20.0) if sp > 0 else 0.0
            gain = min(gain, 0.95 / max(float(np.abs(seg).max()), 1e-6))
            out[pos:pos + dur] += gain * seg
            intervals.append((pos, pos + dur))
        peak = float(np.abs(out).max())
        if peak > 0.95:
            out *= 0.95 / peak
        labels = frame_labels(intervals, self.win,
                              self.frame_length, self.frame_shift)
        return out.astype(np.float32), labels
