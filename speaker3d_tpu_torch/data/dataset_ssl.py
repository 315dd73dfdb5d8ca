"""Multi-crop SSL datasets (RDINO, SDPN) and their batch loader.

The counterpart of ``speaker3d_tpu/data/dataset_ssl.py`` (reference:
speakerlab/dataset/dataset_rdino.py, dataset_sdpn.py): per utterance,
``glb_num`` global crops (``max_frames * 160`` samples, 4 s) and
``local_num`` local crops (half as long); per crop an augmentation profile
drawn from {none, RIR or noise, RIR and noise}, with SNR ranges by noise
category (noise, speech, music) and the RIR gain in [-7, 3] dB. RDINO
augments the globals and the locals; SDPN keeps the globals clean and
augments the locals. Crops are returned as raw waveforms: the train step
computes the mel features on the card (``train/ssl_train.py``).

The draws come from Python's global ``random`` and ``np.random`` in the
JAX package's order, so that at one loader worker, both seeded alike, the
items are byte-equal to the JAX package's. The noise category is the
fourth path component from the end (``.../<category>/<a>/<b>/<file>``);
any other layout counts as ``noise``.

As in the JAX package the crops are mixed at the repo's [-1, 1] float
scale, not the reference's raw int16 scale: the SNR mixing is relative in
dB and the backbone takes a log and an instance norm, so the scale cancels
but for the ``+1e-4`` inside ``log10(mean(x^2) + 1e-4)``, which adds a
little less noise to very quiet audio than the reference would. The JAX
docstring's on-device time/frequency erasing for SDPN exists in no JAX
code path, and the port adds none.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np
from scipy import signal

from speaker3d_tpu_torch.utils.fileio import load_wav_scp, read_wav

SIGPRO_MIN_RANDGAIN = -7
SIGPRO_MAX_RANDGAIN = 3
NOISE_SNR = {"noise": [0, 15], "speech": [13, 20], "music": [5, 15]}


def _read_mono(path):
    wav, _ = read_wav(path)
    return wav[0]


def gene_rir_audio(audio, rir, filter_gain):
    """(reference: dataset_rdino.py gene_rir_audio)"""
    rir = np.multiply(rir, pow(10, 0.1 * float(filter_gain)))
    return signal.convolve(audio, rir, mode="full")[: len(audio)]


def fill_split(path, max_frames):
    """Random fixed-length noise crop (zero-padded if short).
    (reference: dataset_rdino.py fill_split, train path)"""
    max_audio = max_frames * 160
    audio = _read_mono(path)
    if audio.shape[0] <= max_audio:
        audio = np.pad(audio, (0, max_audio - audio.shape[0]))
    start = int(random.random() * (audio.shape[0] - max_audio))
    return audio[start:start + max_audio][None].astype(np.float64)


def gener_glob_loc_audio(path, max_frames, glb_num, local_num):
    """(reference: dataset_rdino.py Gener_glob_loc_audio)"""
    max_audio = max_frames * 160
    audio = _read_mono(path).astype(np.float64)
    if audio.shape[0] <= max_audio:
        audio = np.pad(audio, (0, max_audio - audio.shape[0] + glb_num))
    n = audio.shape[0]

    glb_starts = random.sample(range(0, n - max_audio), glb_num)
    glb = np.stack([audio[s:s + max_audio] for s in glb_starts])
    loc_len = math.floor(max_audio / 2)
    loc_starts = random.sample(range(0, n - loc_len), local_num)
    loc = np.stack([audio[s:s + loc_len] for s in loc_starts])
    return glb, loc


class _SSLCropsBase:
    def __init__(self, data, noise=None, rir_bank: Optional[str] = None,
                 max_frames: int = 400, glb_num: int = 2, local_num: int = 4):
        self.files = list(load_wav_scp(data).values())
        self.max_frames = max_frames
        self.glb_num = glb_num
        self.local_num = local_num
        self.rir = np.load(rir_bank) if rir_bank else None
        self.noise: dict = {}
        if noise:
            for _id, path in load_wav_scp(noise).items():
                parts = path.split("/")
                ntype = parts[-4] if len(parts) >= 4 else "noise"
                if ntype not in NOISE_SNR:
                    ntype = "noise"
                self.noise.setdefault(ntype, []).append(path)
        self.noise_types = list(self.noise.keys())

    def __len__(self):
        return len(self.files)

    def _profile(self):
        """(reference: dataset_rdino.py:62-81 augment profile distribution)"""
        if self.rir is None and not self.noise_types:
            return {"add_rir": None, "rir_gain": None,
                    "add_noise": None, "noise_snr": None}
        rir_file = random.choice(self.rir) if self.rir is not None else None
        if self.noise_types:
            ntype = random.choice(self.noise_types)
            noise_file = random.choice(self.noise[ntype])
            snr = random.uniform(*NOISE_SNR[ntype])
        else:
            noise_file, snr = None, None
        gain = np.random.uniform(SIGPRO_MIN_RANDGAIN, SIGPRO_MAX_RANDGAIN)
        pick = random.choice([0, 1, 1, 1, 2, 2])
        if pick == 0:
            return {"add_rir": None, "rir_gain": None,
                    "add_noise": None, "noise_snr": None}
        if pick == 1:
            if random.random() > 0.75 and rir_file is not None:
                return {"add_rir": rir_file, "rir_gain": gain,
                        "add_noise": None, "noise_snr": None}
            return {"add_rir": None, "rir_gain": None,
                    "add_noise": noise_file, "noise_snr": snr}
        return {"add_rir": rir_file, "rir_gain": gain,
                "add_noise": noise_file, "noise_snr": snr}

    def _augment(self, audio, profile, is_global: bool):
        """(reference: dataset_rdino.py augment_wav)"""
        if profile["add_rir"] is not None:
            audio = gene_rir_audio(audio, profile["add_rir"],
                                   profile["rir_gain"])
        if profile["add_noise"] is not None:
            frames = self.max_frames if is_global else math.floor(
                self.max_frames / 2)
            noise = fill_split(profile["add_noise"], frames)
            noise_db = 10 * np.log10(np.mean(noise[0] ** 2) + 1e-4)
            clean_db = 10 * np.log10(np.mean(audio ** 2) + 1e-4)
            scale = np.sqrt(10 ** ((clean_db - noise_db
                                    - profile["noise_snr"]) / 10))
            audio = audio + scale * noise[0]
        return audio


class RDINODataset(_SSLCropsBase):
    """Augmented globals + augmented locals.
    Returns {'global_wavs': [glb, Lg], 'local_wavs': [loc, Ll]} float32."""

    def __getitem__(self, index):
        glb, loc = gener_glob_loc_audio(self.files[index], self.max_frames,
                                        self.glb_num, self.local_num)
        glb = np.stack([self._augment(g, self._profile(), True) for g in glb])
        loc = np.stack([self._augment(l, self._profile(), False) for l in loc])
        return {"global_wavs": glb.astype(np.float32),
                "local_wavs": loc.astype(np.float32)}


class SDPNDataset(_SSLCropsBase):
    """CLEAN globals + augmented locals (reference: dataset_sdpn.py)."""

    def __getitem__(self, index):
        glb, loc = gener_glob_loc_audio(self.files[index], self.max_frames,
                                        self.glb_num, self.local_num)
        loc = np.stack([self._augment(l, self._profile(), False) for l in loc])
        return {"global_wavs": glb.astype(np.float32),
                "local_wavs": loc.astype(np.float32)}


class SSLBatchLoader:
    """Batches multi-crop samples SAMPLE-major: yields
    {'global_wavs': [B, glb, Lg], 'local_wavs': [B, loc, Ll]} float32, the
    batches of an epoch in the order of ``random.Random(seed + epoch)``'s
    shuffle, each assembled by a pool of ``num_workers`` threads on a
    producer thread (up to 4 batches ahead). A dataset error reaches the
    consumer. The train step transposes to the crop-major layout."""

    def __init__(self, dataset, batch_size: int, shuffle=True, num_workers=8,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        n_batches = len(self)

        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        idxs = order[b * self.batch_size:
                                     (b + 1) * self.batch_size]
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                        glb = np.stack([s["global_wavs"] for s in samples])
                        loc = np.stack([s["local_wavs"] for s in samples])
                        if not put({"global_wavs": glb, "local_wavs": loc}):
                            return
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                put(e)
                return
            put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
