"""AVA-ActiveSpeaker dataset for TalkNet training (host numpy and cv2).

The counterpart of ``speaker3d_tpu/data/dataset_asd.py``, copied: for the
same state of Python's ``random`` and numpy's global generator, every item
is byte-equal to the JAX loader's. The clip list is sorted by length and
cut into mini-batches of ``max(int(batch_size / length), 1)`` clips of the
batch's shortest length (so each batch has a shape of its own). Per clip:
the 16 kHz wav -> MFCC (13 coefficients, the window scaled by 25 / fps;
``ops/mfcc.py``), the face-crop jpg sequence -> 112 x 112 grey frames with
a random flip, crop or rotation (cv2, imported in ``load_visual`` only),
the per-frame binary labels; the audio overlapped with another clip of the
batch at a random SNR in [-5, 5] dB. The draws per clip, in order: the
overlap's coin, clip and SNR (``random``), then the crop's size and corner
(``random.uniform``, ``np.random.randint``), the rotation and the choice.
"""

from __future__ import annotations

import glob
import os
import random

import numpy as np

from speaker3d_tpu_torch.ops.mfcc import mfcc
from speaker3d_tpu_torch.utils.fileio import read_wav


def generate_audio_set(data_path, batch_list):
    """(reference: dataset_asd.py:5-13)"""
    audio_set = {}
    for line in batch_list:
        data = line.split("\t")
        video_name = data[0][:11]
        data_name = data[0]
        wav, _ = read_wav(os.path.join(data_path, video_name,
                                       data_name + ".wav"))
        audio_set[data_name] = (wav[0] * 32768).astype(np.int16)
    return audio_set


def overlap(data_name, audio, audio_set):
    """Overlap another clip's audio at random SNR in [-5, 5] dB.
    (reference: dataset_asd.py:15-30)"""
    if len(set(audio_set.keys())) == 1:
        return audio
    noise_name = random.sample(sorted(set(audio_set.keys()) - {data_name}), 1)[0]
    noise = audio_set[noise_name].astype(np.float64)
    audio = np.asarray(audio, dtype=np.float64)
    snr = random.uniform(-5, 5)
    if len(noise) < len(audio):
        noise = np.pad(noise, (0, len(audio) - len(noise)), "wrap")
    else:
        noise = noise[:len(audio)]
    noise_db = 10 * np.log10(np.mean(np.abs(noise ** 2)) + 1e-4)
    clean_db = 10 * np.log10(np.mean(np.abs(audio ** 2)) + 1e-4)
    noise = np.sqrt(10 ** ((clean_db - noise_db - snr) / 10)) * noise
    return (audio + noise).astype(np.int16)


def load_audio(data, num_frames, audio_aug, audio_set):
    """(reference: dataset_asd.py:32-48)"""
    data_name = data[0]
    fps = float(data[2])
    audio = audio_set[data_name]
    if audio_aug and random.randint(0, 1) == 1:
        audio = overlap(data_name, audio, audio_set)
    feats = mfcc(audio, 16000, numcep=13, winlen=0.025 * 25 / fps,
                 winstep=0.010 * 25 / fps)
    max_audio = int(num_frames * 4)
    if feats.shape[0] < max_audio:
        feats = np.pad(feats, ((0, max_audio - feats.shape[0]), (0, 0)), "wrap")
    return feats[:int(round(num_frames * 4))].astype(np.float32)


def load_visual(data, video_dir, num_frames, visual_aug):
    """(reference: dataset_asd.py:50-78)"""
    import cv2

    data_name = data[0]
    video_name = data[0][:11]
    folder = os.path.join(video_dir, video_name, data_name)
    files = sorted(glob.glob(f"{folder}/*.jpg"),
                   key=lambda p: float(os.path.basename(p)[:-4]))
    H = 112
    if visual_aug:
        new = int(H * random.uniform(0.7, 1))
        x, y = np.random.randint(0, H - new), np.random.randint(0, H - new)
        M = cv2.getRotationMatrix2D((H / 2, H / 2), random.uniform(-15, 15), 1)
        aug_type = random.choice(["orig", "flip", "crop", "rotate"])
    else:
        aug_type = "orig"
    faces = []
    for f in files[:num_frames]:
        face = cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2GRAY)
        face = cv2.resize(face, (H, H))
        if aug_type == "flip":
            face = cv2.flip(face, 1)
        elif aug_type == "crop":
            face = cv2.resize(face[y:y + new, x:x + new], (H, H))
        elif aug_type == "rotate":
            face = cv2.warpAffine(face, M, (H, H))
        faces.append(face)
    return np.array(faces, dtype=np.float32)


def load_label(data, num_frames):
    labels = data[3].replace("[", "").replace("]", "").split(",")
    return np.array([int(x) for x in labels[:num_frames]], np.int32)


class TrainData:
    """Length-sorted mini-batches. (reference: dataset_asd.py:90-122)"""

    def __init__(self, train_csv, audio_dir, video_dir, batch_size):
        self.audio_dir = audio_dir
        self.video_dir = video_dir
        self.mini_batch = []
        with open(train_csv) as f:
            mix_lst = f.read().splitlines()
        sorted_lst = sorted(
            mix_lst, key=lambda d: (int(d.split("\t")[1]),
                                    int(d.split("\t")[-1])), reverse=True)
        start = 0
        while True:
            length = int(sorted_lst[start].split("\t")[1])
            end = min(len(sorted_lst), start + max(int(batch_size / length), 1))
            self.mini_batch.append(sorted_lst[start:end])
            if end == len(sorted_lst):
                break
            start = end

    def __len__(self):
        return len(self.mini_batch)

    def __getitem__(self, index):
        batch_list = self.mini_batch[index]
        num_frames = int(batch_list[-1].split("\t")[1])
        audio_set = generate_audio_set(self.audio_dir, batch_list)
        audio, visual, labels = [], [], []
        for line in batch_list:
            data = line.split("\t")
            audio.append(load_audio(data, num_frames, True, audio_set))
            visual.append(load_visual(data, self.video_dir, num_frames, True))
            labels.append(load_label(data, num_frames))
        return (np.stack(audio), np.stack(visual),
                np.stack(labels))


class ValData:
    """(reference: dataset_asd.py:125-147)"""

    def __init__(self, val_csv, audio_dir, video_dir):
        self.audio_dir = audio_dir
        self.video_dir = video_dir
        with open(val_csv) as f:
            self.mini_batch = f.read().splitlines()

    def __len__(self):
        return len(self.mini_batch)

    def __getitem__(self, index):
        line = [self.mini_batch[index]]
        num_frames = int(line[0].split("\t")[1])
        audio_set = generate_audio_set(self.audio_dir, line)
        data = line[0].split("\t")
        audio = [load_audio(data, num_frames, False, audio_set)]
        visual = [load_visual(data, self.video_dir, num_frames, False)]
        labels = [load_label(data, num_frames)]
        return np.stack(audio), np.stack(visual), np.stack(labels)
