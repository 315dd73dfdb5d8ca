"""Supervised SV dataset and the threaded host batch loader.

The counterpart of ``speaker3d_tpu/data/dataset.py``: a CSV row -> wav crop
(speed perturbation) -> label -> augmentation -> sample. Samples are raw
wav crops: fbank runs on the card inside the train step. ``BatchLoader``
assembles fixed-shape numpy batches on a thread pool, shuffled by a
``random.Random(seed + epoch)``, the last partial batch dropped, wavs
optionally shipped as PCM16 (``wire_dtype='int16'``, half the bytes; the
step decodes k/32768 on the card). Several processes share an epoch's
order round-robin (``process_index`` of ``process_count``; on a mesh a
rank's share is its data index), each cut to the same length so that every
process yields the same number of batches.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from speaker3d_tpu_torch.data.processors import SpkLabelEncoder, SpkVeriAug, WavReader
from speaker3d_tpu_torch.utils.fileio import load_data_csv


class WavSVDataset:
    def __init__(self, data_file, wav_reader: WavReader,
                 label_encoder: SpkLabelEncoder,
                 augmentations: Optional[SpkVeriAug] = None):
        self.data = load_data_csv(data_file)
        self.keys = list(self.data.keys())
        self.wav_reader = wav_reader
        self.label_encoder = label_encoder
        self.augmentations = augmentations

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        row = self.data[self.keys[index]]
        wav, speed_idx = self.wav_reader(row["wav"])
        label = self.label_encoder(row["spk"], speed_idx)
        if self.augmentations is not None:
            wav = self.augmentations(wav)
        return wav.astype(np.float32), np.int32(label)

    @property
    def num_classes(self):
        mult = 3 if self.wav_reader.speed_pertub else 1
        return len(self.label_encoder) * mult


class BatchLoader:
    """Prefetching batch iterator over a map-style dataset: yields
    ``{'wavs': [B, L] float32 (or int16), 'labels': [B] int32}``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True, wire_dtype: Optional[str] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        # 'int16': PCM16 on the wire. Exact for PCM16-decoded samples;
        # augmented values re-quantize to within 1/65536, and a peak past
        # +-1 (resampler ringing, addnoise) saturates in the clip below
        if wire_dtype not in (None, "int16"):
            raise ValueError(
                f"wire_dtype must be None|'int16', got {wire_dtype!r} "
                "(config key: wire_dtype; 'float32' maps to None upstream)")
        self.wire_dtype = wire_dtype
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        # every process takes as many examples, so that none waits in a
        # collective for a peer that has run out
        order = order[self.process_index::self.process_count][
            : len(self.dataset) // self.process_count]
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # always end the queue: a worker's exception reaches the consumer
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        # one future per worker over contiguous slices, so the
                        # sample order is the sequential one (num_workers=1
                        # is deterministic)
                        nw = max(1, min(self.num_workers, len(idxs)))
                        step = -(-len(idxs) // nw)
                        chunks = [idxs[j * step:(j + 1) * step]
                                  for j in range(nw)]
                        get = self.dataset.__getitem__
                        parts = pool.map(lambda ch: [get(i) for i in ch], chunks)
                        samples = [s for part in parts for s in part]
                        wavs = np.stack([s[0] for s in samples])
                        labels = np.asarray([s[1] for s in samples], np.int32)
                        if self.wire_dtype == "int16":
                            wavs = np.clip(np.rint(wavs * 32768.0),
                                           -32768, 32767).astype(np.int16)
                        q.put({"wavs": wavs, "labels": labels})
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                q.put(exc)
            else:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
