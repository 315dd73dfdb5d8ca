"""DNN VAD for diarization: a trained DFSMN -> speech flags every 10 ms.

The counterpart of ``speaker3d_tpu/diar/dnn_vad.py``. ``DnnVAD`` plugs into
``DiarizationPipeline`` as its ``vad`` callable (wav[n] -> (flags, clipped
wav)) and advertises its 10 ms fbank hop as ``frame_ms``, so the pipeline's
post-processing windows keep their durations.

The file is cut into windows of ``chunk_frames`` frames plus ``ctx_frames``
frames of context on each side (at least the model's receptive field), all
of one shape: the waveform is uploaded once, each batch of windows is
gathered from it on the device, zero outside the file, and runs through the
Kaldi fbank (the fbank kernel on a card) with no mean-norm and the model in
fp32 (TF32 off). The features are absolute log-mel and the FIR memory has
no state, so the core frames' outputs do not depend on the chunk grid. The
probabilities come back in one copy.

``load_vad_exp`` builds it from an experiment of either package's VAD
trainer (``cli/train_vad.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.models.fsmn_vad import FSMNVad
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank


def gather_windows(wav: torch.Tensor, starts: torch.Tensor,
                   length: int) -> torch.Tensor:
    """wav [n + 1] float32 whose last sample is 0, starts [B] int64 (may be
    negative) -> [B, length] with row i = wav[starts[i] + t] for samples
    inside [0, n), else 0."""
    n = wav.shape[0] - 1
    idx = starts[:, None] + torch.arange(length, device=wav.device)[None, :]
    return wav[torch.where((idx < 0) | (idx >= n), n, idx)]


class FsmnFrontEnd:
    """An FSMN model behind the Kaldi fbank (no mean-norm) on one device:
    ``probs`` runs batches of windows gathered from one upload of the
    waveform."""

    def __init__(self, model: torch.nn.Module, sample_rate: int,
                 batch_size: int, device):
        self.device = resolve_device(device)
        self.fs = sample_rate
        self.model = model.to(self.device).eval()
        self.cfg = FbankConfig(sample_rate=sample_rate,
                               num_mel_bins=model.feat_dim)
        self.fbank = KaldiFbank(self.cfg, mean_norm=False, device=self.device)
        self.frame_length = self.cfg.frame_length
        self.frame_shift = self.cfg.frame_shift
        self.batch = batch_size

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        """[b, samples] float32 on the device -> sigmoid of the model's
        logits, in fp32 with TF32 off."""
        with torch.inference_mode(), matmul_precision("float32"):
            return torch.sigmoid(self.model(self.fbank(wavs)))

    def probs(self, x: np.ndarray, starts: np.ndarray,
              length: int) -> np.ndarray:
        """Probabilities of the windows [starts[i], starts[i] + length) of
        x, in batches of ``batch_size`` (the last one zero-padded)."""
        wav = torch.zeros(x.shape[0] + 1, dtype=torch.float32,
                          device=self.device)
        wav[:-1] = torch.from_numpy(x).to(self.device)
        n = len(starts)
        padded = np.full(-(-n // self.batch) * self.batch, x.shape[0],
                         np.int64)  # padding windows start past the end
        padded[:n] = starts
        st = torch.from_numpy(padded).to(self.device)
        outs = [self.forward(gather_windows(wav, st[i:i + self.batch], length))
                for i in range(0, len(padded), self.batch)]
        return torch.cat(outs)[:n].cpu().numpy()


class DnnVAD(FsmnFrontEnd):
    """Callable VAD with the EnergyVAD interface (``diar/vad.py``)."""

    def __init__(self, model: FSMNVad, sample_rate: int = 16000,
                 threshold: float = 0.5, chunk_frames: int = 512,
                 ctx_frames: Optional[int] = None, batch_size: int = 4,
                 device=DEFAULT_DEVICE):
        super().__init__(model, sample_rate, batch_size, device)
        self.threshold = threshold
        self.frame_ms = 10.0
        if ctx_frames is None:
            ctx_frames = max(model.receptive_field)
        self.chunk = chunk_frames
        self.ctx = ctx_frames
        self.win_frames = chunk_frames + 2 * ctx_frames
        self.win_samples = (self.win_frames - 1) * self.frame_shift \
            + self.frame_length

    def frame_probs(self, wav_1d):
        """(P(speech) per 10 ms frame [T] float32, the waveform clipped to
        [-1, 1]); T = 0 for input shorter than one frame."""
        x = np.clip(np.asarray(wav_1d, np.float32).reshape(-1), -1.0, 1.0)
        n = x.shape[0]
        if n < self.frame_length:
            return np.zeros(0, np.float32), x
        t = 1 + (n - self.frame_length) // self.frame_shift
        n_chunks = -(-t // self.chunk)
        # the first frame of window k is k * chunk - ctx
        starts = (np.arange(n_chunks) * self.chunk - self.ctx) * self.frame_shift
        probs = self.probs(x, starts, self.win_samples)
        core = probs[:, self.ctx:self.ctx + self.chunk]
        return core.reshape(-1)[:t], x

    def __call__(self, wav_1d):
        """(speech flags per 10 ms frame, [] for input shorter than one
        frame; the clipped waveform)."""
        probs, x = self.frame_probs(wav_1d)
        return (probs > self.threshold).astype(int).tolist(), x


def load_fsmn_exp(exp_dir: str, model_cls, config_keys=()):
    """(config, model with the latest checkpoint's weights) of an FSMN
    experiment written by either package's trainer: ``config.yaml``'s
    ``model.args`` build ``model_cls``, completed by the top-level
    ``config_keys`` it lacks; ``models/``' latest ``train_state.ckpt``
    holds the Flax ``params`` tree."""
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.config import build_config

    config = build_config(os.path.join(exp_dir, "config.yaml"))
    margs = dict(config.get("model", {}).get("args", {}))
    for key in config_keys:
        if key in config:
            margs.setdefault(key, config[key])
    model = model_cls(**margs)
    recovered = Checkpointer(os.path.join(exp_dir, "models")
                             ).recover_if_possible()
    if recovered is None or "train_state" not in recovered:
        raise FileNotFoundError(f"no checkpoint under {exp_dir}/models")
    model.load_state_dict(state_dict_from_flax(
        {"params": recovered["train_state"]["params"]},
        like=model.state_dict()), strict=True)
    return config, model


def load_vad_exp(exp_dir: str, sample_rate: int = 16000,
                 threshold: float = 0.5, device=DEFAULT_DEVICE,
                 **vad_kwargs) -> DnnVAD:
    """A DnnVAD on ``device`` from a VAD experiment directory."""
    dev = resolve_device(device)
    _, model = load_fsmn_exp(exp_dir, FSMNVad)
    return DnnVAD(model, sample_rate=sample_rate, threshold=threshold,
                  device=dev, **vad_kwargs)
