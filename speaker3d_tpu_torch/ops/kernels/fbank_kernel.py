"""Kaldi fbank spectral pipeline: the Hopper kernel and its plain version.

The counterpart of ``speaker3d_tpu/ops/pallas/fbank_kernel.py``. Per frame:
``frame @ B`` (DC removal, pre-emphasis, window and padded rDFT folded into
one matrix), power spectrum, ``@ mel``, ``log(max(., eps))``. The CUDA
kernel (``csrc/fbank.cu``) reads its frames straight from the waveform at
stride ``frame_shift`` and runs both products on the tensor cores in 3xTF32,
with B and mel split and packed once by ``pack_fbank``; the plain version
frames with ``Tensor.unfold``. Mean-norm stays outside, as in the TPU
kernel's wrapper.

``fbank_features`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; ``fbank_features.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from speaker3d_tpu_torch.kernels.build import check, library
from speaker3d_tpu_torch.ops.kernels.tf32 import pack_b, round8

_EPSILON = float(np.finfo(np.float32).eps)
# rDFT bins the kernel computes (half the padded window; csrc/fbank.cu
# MIN_BINS, MAX_BINS): 128 at 8 kHz, 256 at 16 kHz, 1024 at 48 kHz
_MIN_BINS, _MAX_BINS = 128, 1024
_MAX_MEL = 80  # mel bins the kernel takes (csrc/fbank.cu MAX_NMT n-tiles)


def fbank_plain(wav, B, mel, *, frame_length: int, frame_shift: int,
                use_power: bool = True, use_log: bool = True):
    """wav [batch, n] float32 -> log-mel [batch, T, M]; fp32 matmuls."""
    n_bins = mel.shape[0]
    n = wav.shape[-1]
    if n < frame_length:  # shorter than one frame: 0 frames
        return wav.new_zeros((wav.shape[0], 0, mel.shape[1]))
    frames = wav.unfold(-1, frame_length, frame_shift)       # [b, T, L]
    y = torch.matmul(frames, B)                               # [b, T, 2R]
    power = y[..., :n_bins].square() + y[..., n_bins:].square()
    if not use_power:
        power = power.sqrt()
    feats = torch.matmul(power, mel)
    if use_log:
        feats = torch.log(torch.clamp(feats, min=_EPSILON))
    return feats


def _lib():
    lib = library("fbank")
    if not getattr(lib, "_s3d_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.s3d_fbank_f32.restype = i
        lib.s3d_fbank_f32.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib._s3d_bound = True
    return lib


def check_mel_for_kernel(mel) -> int:
    """The kernel computes bins 0..n_bins-1 of a power-of-two rDFT only: the
    matrix must have n_bins + 1 rows, n_bins a power of two from 128 to 1024
    (a padded window of 256 to 2048 samples, FbankConfig's
    round_to_power_of_two), with a zero Nyquist row (true of every Kaldi
    ``mel_banks`` matrix) and at most 80 columns. Returns n_bins."""
    n_bins = mel.shape[0] - 1
    if (n_bins & (n_bins - 1) or not _MIN_BINS <= n_bins <= _MAX_BINS):
        raise ValueError(
            f"the fbank kernel takes a power-of-two padded window of "
            f"{2 * _MIN_BINS} to {2 * _MAX_BINS} samples ({_MIN_BINS} to "
            f"{_MAX_BINS} rDFT bins, FbankConfig.round_to_power_of_two=True); "
            f"got a {2 * n_bins}-point window ([{n_bins + 1}, M] mel matrix)")
    if bool((mel[n_bins:] != 0).any()):
        raise ValueError(f"the fbank kernel needs a [{n_bins + 1}, M] mel "
                         f"matrix with a zero Nyquist row (Kaldi banks)")
    if mel.shape[1] > _MAX_MEL:
        raise ValueError(f"the fbank kernel takes at most {_MAX_MEL} mel "
                         f"bins, got {mel.shape[1]}")
    return n_bins


@dataclass(frozen=True)
class PackedFbank:
    """The kernel's operands, 3xTF32 B fragments (``tf32.pack_b``)."""

    dft: torch.Tensor  # [ceil(L / 8), n_bins / 4, 32, 4]: B's bins, columns (re_k, im_k)
    mel: torch.Tensor  # [n_bins / 8, ceil(M / 8), 32, 4]: mel rows 0..n_bins-1
    n_bins: int
    n_mel: int


def pack_fbank(B, mel) -> PackedFbank:
    """Split and pack B [L, 2R] and mel [R, M] (R = n_bins + 1, zero Nyquist
    row; ``check_mel_for_kernel``) for the kernel, on their device: B's
    columns of bins 0..n_bins-1 interleaved as (re_0, im_0, re_1, ...), so
    that an mma C fragment holds a bin's real and imaginary parts in one
    lane."""
    nb = check_mel_for_kernel(mel)
    R = nb + 1
    B = torch.as_tensor(B, dtype=torch.float32)
    mel = torch.as_tensor(mel, dtype=torch.float32)
    if B.shape[1] != 2 * R:
        raise ValueError(f"fbank kernel: B must be [L, {2 * R}] for a "
                         f"[{R}, M] mel matrix, got {tuple(B.shape)}")
    inter = torch.stack([B[:, :nb], B[:, R:R + nb]], dim=-1).reshape(
        B.shape[0], 2 * nb)
    return PackedFbank(pack_b(inter), pack_b(mel[:nb]), nb, mel.shape[1])


def fbank_cuda(wav, packed: PackedFbank, *, frame_length: int,
               frame_shift: int, use_power: bool = True,
               use_log: bool = True):
    """Launch csrc/fbank.cu on wav's CUDA device with operands from
    ``pack_fbank``."""
    if not wav.is_cuda or wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("fbank kernel: wav must be a contiguous float32 CUDA "
                         "tensor")
    if wav.ndim != 2:
        raise ValueError(f"fbank kernel: wav must be [batch, n], got "
                         f"{tuple(wav.shape)}")
    M, nb = packed.n_mel, packed.n_bins
    want = {"dft": (round8(frame_length) // 8, nb // 4, 32, 4),
            "mel": (nb // 8, round8(M) // 8, 32, 4)}
    for name, shape in want.items():
        t = getattr(packed, name)
        if (t.device != wav.device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"fbank kernel: packed {name} must be a "
                             f"contiguous float32 {shape} tensor on wav's "
                             f"device (pack_fbank)")
    batch, n = wav.shape
    n_frames = 1 + (n - frame_length) // frame_shift if n >= frame_length else 0
    out = torch.empty((batch, n_frames, M), dtype=torch.float32,
                      device=wav.device)
    if batch == 0 or n_frames == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    rc = lib.s3d_fbank_f32(wav.data_ptr(), packed.dft.data_ptr(),
                           packed.mel.data_ptr(), out.data_ptr(), batch, n,
                           n_frames, frame_shift, want["dft"][0], nb, M,
                           int(use_power), int(use_log), stream)
    check(lib, rc, "s3d_fbank_f32")
    fbank_features.launches += 1
    return out


def fbank_features(wav, B, mel, packed=None, *, frame_length: int,
                   frame_shift: int, use_power: bool = True,
                   use_log: bool = True):
    """[batch, n] float32 -> [batch, T, M]: the kernel on a CUDA tensor
    (``packed`` from ``pack_fbank``), the plain version on a CPU tensor."""
    kw = dict(frame_length=frame_length, frame_shift=frame_shift,
              use_power=use_power, use_log=use_log)
    if wav.is_cuda:
        if packed is None:
            raise ValueError("fbank: a CUDA tensor needs the packed operands "
                             "(pack_fbank)")
        return fbank_cuda(wav, packed, **kw)
    if wav.device.type != "cpu":
        raise ValueError(f"fbank: unsupported device {wav.device}")
    return fbank_plain(wav, B, mel, **kw)


fbank_features.launches = 0
