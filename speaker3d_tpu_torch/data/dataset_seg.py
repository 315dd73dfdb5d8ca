"""Synthetic multi-speaker mixture dataset for segmentation training.

The counterpart of ``speaker3d_tpu/data/dataset_seg.py``, copied: the same
``default_rng((seed, index))`` draws give byte-equal items. Events from k
distinct speakers (k in 0..max_speakers) are placed in the window, and may
overlap; the targets are per-frame, per-speaker activations [T,
max_speakers] in first-appearance channel order (the PIT loss,
``models/segmentation.py::pit_bce``, makes the order immaterial).

Speech sources carry speaker identity: a CSV with ``ID,wav,spk`` columns
or a wav.scp plus utt2spk pair.

Emits (wav [L] float32, labels [T, K] int32) with T the Kaldi snip-edges
frame count of L.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from speaker3d_tpu_torch.data.dataset_vad import SyntheticVadDataset, _load_source_list
from speaker3d_tpu_torch.utils.fileio import load_audio, load_data_csv, load_wav_scp


def _load_speaker_map(speech: str, utt2spk: Optional[str]) -> Dict[str, List[str]]:
    """speaker -> [wav paths]."""
    spk2wavs: Dict[str, List[str]] = {}
    if speech.endswith(".csv"):
        for row in load_data_csv(speech).values():
            spk2wavs.setdefault(str(row["spk"]), []).append(row["wav"])
    elif utt2spk:
        wavs = load_wav_scp(speech)
        with open(utt2spk) as f:
            for line in f:
                utt, spk = line.split()
                if utt in wavs:
                    spk2wavs.setdefault(spk, []).append(wavs[utt])
    else:
        raise ValueError(
            "segmentation training needs speaker labels: pass a CSV with "
            "ID,wav,spk columns or wav.scp + utt2spk")
    if not spk2wavs:
        raise ValueError(f"no labelled speech sources in {speech}")
    return spk2wavs


class SyntheticSegmentationDataset(SyntheticVadDataset):
    """Map-style dataset of k-speaker mixtures with per-speaker frame targets."""

    def __init__(self, speech: str, noise: Optional[str] = None,
                 utt2spk: Optional[str] = None,
                 sample_rate: int = 16000, window_dur: float = 5.0,
                 max_speakers: int = 3, events_per_speaker: int = 2,
                 min_event_dur: float = 0.4,
                 snr_range: tuple = (0.0, 20.0), seed: int = 0,
                 size: Optional[int] = None,
                 frame_length: int = 400, frame_shift: int = 160):
        self.spk2wavs = _load_speaker_map(speech, utt2spk)
        self.speakers = sorted(self.spk2wavs)
        self.noise = _load_source_list(noise) if noise else []
        self.fs = sample_rate
        self.win = int(window_dur * sample_rate)
        self.max_speakers = max_speakers
        self.events_per_speaker = events_per_speaker
        self.min_event = int(min_event_dur * sample_rate)
        self.snr_range = snr_range
        self.seed = seed
        n_utts = sum(len(v) for v in self.spk2wavs.values())
        self.size = size if size is not None else max(n_utts * 4, 64)
        self.frame_length = frame_length
        self.frame_shift = frame_shift

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        if self.noise:
            src = load_audio(self.noise[int(rng.integers(len(self.noise)))],
                             obj_fs=self.fs)
            bed = self._crop(np.asarray(src, np.float32).reshape(-1),
                             self.win, rng)
            bed = bed * float(rng.uniform(0.3, 1.0))
        else:
            bed = rng.standard_normal(self.win).astype(np.float32) * float(
                10 ** rng.uniform(-4.0, -2.0))
        if rng.random() < 0.05:
            bed = np.zeros_like(bed)
        out = bed.copy()

        k = int(rng.integers(0, min(self.max_speakers,
                                    len(self.speakers)) + 1))
        chosen = rng.choice(len(self.speakers), size=k, replace=False)
        t = max(1 + (self.win - self.frame_length) // self.frame_shift, 0)
        labels = np.zeros((t, self.max_speakers), np.int32)
        centers = (np.arange(t) * self.frame_shift + self.frame_length // 2)
        for ch, spk_idx in enumerate(chosen):
            wavs = self.spk2wavs[self.speakers[int(spk_idx)]]
            n_events = int(rng.integers(1, self.events_per_speaker + 1))
            for _ in range(n_events):
                src = load_audio(wavs[int(rng.integers(len(wavs)))],
                                 obj_fs=self.fs)
                src = np.asarray(src, np.float32).reshape(-1)
                dur = int(rng.integers(self.min_event,
                                       max(self.win // 2, self.min_event) + 1))
                seg = self._crop(src, dur, rng)
                pos = int(rng.integers(0, self.win - dur + 1))
                sp = float(np.sqrt(np.mean(seg ** 2) + 1e-12))
                bp = float(np.sqrt(np.mean(bed ** 2) + 1e-12))
                snr = float(rng.uniform(*self.snr_range))
                gain = bp / sp * 10 ** (snr / 20.0) if sp > 0 else 0.0
                gain = min(gain, 0.95 / max(float(np.abs(seg).max()), 1e-6))
                out[pos:pos + dur] += gain * seg
                labels[:, ch] |= ((centers >= pos)
                                  & (centers < pos + dur)).astype(np.int32)
        peak = float(np.abs(out).max())
        if peak > 0.95:
            out *= 0.95 / peak
        return out.astype(np.float32), labels
