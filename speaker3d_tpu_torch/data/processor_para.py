"""Paraformer-style feature processors: low-frame-rate (LFR) stacking and
CMVN.

The counterpart of ``speaker3d_tpu/data/processor_para.py``. LFR windows
``lfr_m`` frames at hop ``lfr_n``, left-padded by repeating the first frame
``(lfr_m - 1) // 2`` times and tail-padded by repeating the last frame, the
``lfr_m`` taps concatenated on the feature axis: ``apply_lfr`` on one
utterance on the host (float32 numpy), ``apply_lfr_device`` on a batch on
its tensor's device. CMVN is ``x = (x + means) * vars`` from a Kaldi-style
``am.mvn`` file's ``<AddShift>`` / ``<Rescale>`` blocks (``load_cmvn``,
``apply_cmvn``). ``cli/train_para.py`` runs the device LFR and the CMVN
in its frozen frontend.
"""

from __future__ import annotations

import numpy as np
import torch


def apply_lfr(inputs: np.ndarray, lfr_m: int, lfr_n: int) -> np.ndarray:
    """inputs [T, D] -> [ceil(T/lfr_n), lfr_m*D]."""
    inputs = np.asarray(inputs)
    T = inputs.shape[0]
    T_lfr = int(np.ceil(T / lfr_n))
    left = np.repeat(inputs[:1], (lfr_m - 1) // 2, axis=0)
    x = np.concatenate([left, inputs], axis=0)
    T_pad = x.shape[0]
    out = []
    for i in range(T_lfr):
        if lfr_m <= T_pad - i * lfr_n:
            out.append(x[i * lfr_n:i * lfr_n + lfr_m].reshape(-1))
        else:
            frame = x[i * lfr_n:].reshape(-1)
            num_pad = lfr_m - (T_pad - i * lfr_n)
            frame = np.concatenate([frame] + [x[-1]] * num_pad)
            out.append(frame)
    return np.stack(out).astype(np.float32)


def apply_cmvn(inputs: np.ndarray, cmvn: np.ndarray) -> np.ndarray:
    """x = (x + means) * vars. cmvn: [2, D]."""
    dim = inputs.shape[-1]
    return ((inputs + cmvn[0:1, :dim]) * cmvn[1:2, :dim]).astype(np.float32)


def load_cmvn(cmvn_file: str) -> np.ndarray:
    """Parse a Kaldi-nnet-style am.mvn (<AddShift>/<Rescale>)."""
    with open(cmvn_file, encoding="utf-8") as f:
        lines = f.readlines()
    means_list, vars_list = [], []
    for i, line in enumerate(lines):
        item = line.split()
        if not item:
            continue
        if item[0] == "<AddShift>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                means_list = nxt[3:len(nxt) - 1]
        elif item[0] == "<Rescale>":
            nxt = lines[i + 1].split()
            if nxt[0] == "<LearnRateCoef>":
                vars_list = nxt[3:len(nxt) - 1]
    return np.stack([np.array(means_list, np.float32),
                     np.array(vars_list, np.float32)])



def apply_lfr_device(x: torch.Tensor, lfr_m: int, lfr_n: int) -> torch.Tensor:
    """[B, T, D] -> [B, ceil(T / lfr_n), lfr_m * D], from strided slices
    (no gather), on ``x``'s device."""
    b, t, d = x.shape
    t_lfr = -(-t // lfr_n)
    left = (lfr_m - 1) // 2
    x = torch.cat([x[:, :1].expand(b, left, d), x], dim=1)
    need = (t_lfr - 1) * lfr_n + lfr_m
    if need > x.shape[1]:
        x = torch.cat([x, x[:, -1:].expand(b, need - x.shape[1], d)], dim=1)
    span = (t_lfr - 1) * lfr_n + 1
    return torch.cat([x[:, i:i + span:lfr_n] for i in range(lfr_m)], dim=-1)
