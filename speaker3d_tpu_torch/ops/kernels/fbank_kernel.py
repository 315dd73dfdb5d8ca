"""Kaldi fbank spectral pipeline: the Hopper kernel and its plain version.

The counterpart of ``speaker3d_tpu/ops/pallas/fbank_kernel.py``. Per frame:
``frame @ B`` (DC removal, pre-emphasis, window and padded rDFT folded into
one matrix), power spectrum, ``@ mel``, ``log(max(., eps))``. The CUDA
kernel (``csrc/fbank.cu``) reads its frames straight from the waveform at
stride ``frame_shift``; the plain version frames with ``Tensor.unfold``.
Mean-norm stays outside, as in the TPU kernel's wrapper.

``fbank_features`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; ``fbank_features.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from speaker3d_tpu_torch.kernels.build import check, library

_EPSILON = float(np.finfo(np.float32).eps)
_NB = 256  # rDFT bins the kernel computes (csrc/fbank.cu NB)


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
        lib.s3d_fbank_smem_bytes.restype = i
        lib.s3d_fbank_smem_bytes.argtypes = [i, i]
        lib._s3d_bound = True
    return lib


def check_mel_for_kernel(mel) -> None:
    """The kernel computes bins 0..255 only: the matrix must have 257 rows
    with a zero Nyquist row (true of every Kaldi ``mel_banks`` matrix)."""
    if mel.shape[0] != _NB + 1 or bool((mel[_NB:] != 0).any()):
        raise ValueError("the fbank kernel needs a [257, M] mel matrix with "
                         "a zero Nyquist row (512-point rDFT, Kaldi banks)")


def fbank_cuda(wav, B, mel, *, frame_length: int, frame_shift: int,
               use_power: bool = True, use_log: bool = True):
    """Launch csrc/fbank.cu on wav's CUDA device (mel checked by the
    caller with ``check_mel_for_kernel``)."""
    for name, t in (("wav", wav), ("B", B), ("mel", mel)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fbank kernel: {name} must be a contiguous "
                             f"float32 CUDA tensor")
    if wav.ndim != 2:
        raise ValueError(f"fbank kernel: wav must be [batch, n], got "
                         f"{tuple(wav.shape)}")
    R = mel.shape[0]
    if B.shape != (frame_length, 2 * R):
        raise ValueError(f"fbank kernel: B is {tuple(B.shape)}, expected "
                         f"({frame_length}, {2 * R})")
    batch, n = wav.shape
    n_frames = 1 + (n - frame_length) // frame_shift if n >= frame_length else 0
    out = torch.empty((batch, n_frames, mel.shape[1]), dtype=torch.float32,
                      device=wav.device)
    if batch == 0 or n_frames == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    rc = lib.s3d_fbank_f32(wav.data_ptr(), B.data_ptr(), mel.data_ptr(),
                           out.data_ptr(), batch, n, n_frames, frame_length,
                           frame_shift, R, mel.shape[1], int(use_power),
                           int(use_log), stream)
    check(lib, rc, "s3d_fbank_f32")
    fbank_features.launches += 1
    return out


def fbank_features(wav, B, mel, *, frame_length: int, frame_shift: int,
                   use_power: bool = True, use_log: bool = True):
    """[batch, n] float32 -> [batch, T, M]: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    kw = dict(frame_length=frame_length, frame_shift=frame_shift,
              use_power=use_power, use_log=use_log)
    if wav.is_cuda:
        return fbank_cuda(wav, B, mel, **kw)
    if wav.device.type != "cpu":
        raise ValueError(f"fbank: unsupported device {wav.device}")
    return fbank_plain(wav, B, mel, **kw)


fbank_features.launches = 0
