"""CTC ASR: the SAN-M encoder with a CTC head, its train step, greedy
timestamped decoding and a sliding-window transcriber.

The counterpart of ``speaker3d_tpu/asr/ctc.py``. ``SANMCTC`` stacks the
log-mel features to a low frame rate (``data/processor_para.py``), runs
``models/sanm.py::SANMEncoder`` and projects to the vocabulary plus the
blank, whose bias starts at 2.0 (a blank-dominant start keeps small models
out of the no-blank CTC solution). The train step is
``train/vad_train.py``'s Adam step in fp32 (TF32 off) with the CTC loss of
each sequence divided by its label count, summed and divided by the batch.
``CTCTranscriber`` loads an experiment of either package's
``cli/train_asr_ctc.py`` and decodes on the card: the fbank (the fbank
kernel) without mean-norm, the experiment's global CMVN, the model, then
the argmax runs on the host.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speaker3d_tpu_torch.data.processor_para import apply_lfr_device
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_
from speaker3d_tpu_torch.models.sanm import FLAX_JOINED_NAMES, SANMEncoder
from speaker3d_tpu_torch.train.vad_train import make_adam_train_step

BLANK_ID = 0  # vocab token ids start at 1
BLANK_PRIOR = 2.0  # ctc_out's initial blank bias


class SANMCTC(nn.Module):
    """Log-mel features [B, T, feat_dim] -> CTC logits over LFR frames
    [B, ceil(T / lfr_n), vocab_size + 1]."""

    flax_joined_names = FLAX_JOINED_NAMES

    def __init__(self, vocab_size: int, feat_dim: int = 80, d_model: int = 256,
                 num_heads: int = 4, ffn_dim: int = 1024, num_layers: int = 4,
                 kernel_size: int = 11, lfr_m: int = 5, lfr_n: int = 4):
        super().__init__()
        self.lfr_m, self.lfr_n = lfr_m, lfr_n
        self.encoder = SANMEncoder(
            input_dim=feat_dim * lfr_m, d_model=d_model, num_heads=num_heads,
            ffn_dim=ffn_dim, num_layers=num_layers, kernel_size=kernel_size)
        self.ctc_out = nn.Linear(d_model, vocab_size + 1)

    def forward(self, feats):
        if self.lfr_n > 1 or self.lfr_m > 1:
            feats = apply_lfr_device(feats, self.lfr_m, self.lfr_n)
        return self.ctc_out(self.encoder(feats))


def init_sanm_ctc_(model: SANMCTC, generator: torch.Generator) -> SANMCTC:
    """Flax's default initial weights (``models/fsmn_vad.py::lecun_init_``)
    with the blank-prior bias of ``ctc_out``."""
    lecun_init_(model, generator)
    with torch.no_grad():
        model.ctc_out.bias[BLANK_ID] = BLANK_PRIOR
    return model


class CTCTrainConfig(NamedTuple):
    min_lr: float = 1e-5
    max_lr: float = 2e-3
    warmup_epoch: int = 1
    fix_epoch: int = 20
    step_per_epoch: int = 100
    weight_decay: float = 1e-6
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


def ctc_loss_per_seq(logits, labels, label_lens):
    """The CTC negative log-likelihood of each sequence: logits [B, T, V+1]
    (every frame valid), labels [B, U] zero-padded, label_lens [B]."""
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    return F.ctc_loss(log_probs, labels.long(),
                      input_lengths=torch.full((b,), t, dtype=torch.long),
                      target_lengths=label_lens.long().cpu(),
                      blank=BLANK_ID, reduction="none")


def ctc_loss(logits, batch):
    """(the loss of the JAX step: each sequence's CTC loss over its label
    count (at least 1), summed over the batch / B; no accuracy)."""
    lens = batch["label_lens"]
    per_seq = ctc_loss_per_seq(logits, batch["labels"], lens)
    denom = torch.clamp(lens.to(per_seq.device, torch.float32), min=1.0)
    return (per_seq / denom).sum() / logits.shape[0], None


def make_ctc_train_step(cfg: CTCTrainConfig,
                        feature_fn: Optional[Callable] = None) -> Callable:
    """Batches: ``{'wavs' [B, L] (or 'feats' [B, T, F]), 'labels' [B, U]
    int32 (0-padded), 'label_lens' [B] int32}``; the state is
    ``train/vad_train.py::AdamTrainState``."""
    return make_adam_train_step(ctc_loss, cfg, feature_fn)


def greedy_decode(logits: np.ndarray,
                  frame_dur_s: float) -> List[Tuple[int, float, float]]:
    """CTC greedy decode of [T, V+1] logits -> [(token_id, st_s, ed_s)]:
    repeated frame argmaxes collapse into runs, blanks drop, and each
    token spans its run of frames."""
    ids = np.asarray(logits).argmax(axis=-1)
    out = []
    t = 0
    T = ids.shape[0]
    while t < T:
        tok = ids[t]
        start = t
        while t < T and ids[t] == tok:
            t += 1
        if tok != BLANK_ID:
            out.append((int(tok), start * frame_dur_s, t * frame_dur_s))
    return out


def tokens_to_asr_result(decoded: Sequence[Tuple[int, float, float]],
                         vocab: Sequence[str]) -> dict:
    """(token, st, ed) runs -> the ASR triple of ``diar/transcribe.py``:
    punctuated text, space-separated raw_text, per-word [st, ed]. vocab[0]
    is token id 1."""
    words = [vocab[tok - 1] for tok, _, _ in decoded]
    text = " ".join(words) + ("." if words else "")
    return {"text": text, "raw_text": " ".join(words),
            "timestamp": [[st, ed] for _, st, ed in decoded]}


class CTCTranscriber:
    """A ``cli/train_asr_ctc.py`` experiment of either package, decoding
    wavs on ``device``."""

    def __init__(self, exp_dir: str, sample_rate: int = 16000,
                 device=DEFAULT_DEVICE):
        from speaker3d_tpu_torch.compat.flax_convert import (
            state_dict_from_flax)
        from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
        from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
        from speaker3d_tpu_torch.utils.config import build_config

        self.device = resolve_device(device)
        config = build_config(os.path.join(exp_dir, "config.yaml"))
        with open(os.path.join(exp_dir, "vocab.json"), encoding="utf-8") as f:
            self.vocab = json.load(f)
        margs = dict(config.get("model", {}).get("args", {}))
        self.model = SANMCTC(vocab_size=len(self.vocab), **margs)
        states = Checkpointer(os.path.join(exp_dir, "models")) \
            .recover_if_possible()
        if states is None or "train_state" not in states:
            raise FileNotFoundError(f"no checkpoint under {exp_dir}/models")
        self.model.load_state_dict(state_dict_from_flax(
            {"params": states["train_state"]["params"]},
            like=self.model.state_dict()), strict=True)
        self.model.to(self.device).eval()
        self.sample_rate = config.get("sample_rate", sample_rate)
        self.fbank = KaldiFbank(FbankConfig(
            sample_rate=self.sample_rate,
            num_mel_bins=config.get("n_mels", 80)), mean_norm=False,
            device=self.device)
        # the trainer's global CMVN (Paraformer's am.mvn convention)
        self.cmvn = np.load(os.path.join(exp_dir, "cmvn.npy"))
        self._cmvn = torch.as_tensor(self.cmvn, device=self.device)
        self.frame_dur_s = 0.010 * self.model.lfr_n  # fbank hop x LFR
        self.window_s = float(config.get("wav_len", 4.0))
        self.overlap_s = 0.5

    def logits(self, wav) -> torch.Tensor:
        """One window [n] -> CTC logits [T, V+1] on the device (fp32, TF32
        off)."""
        from speaker3d_tpu_torch.eval.embedding import matmul_precision

        with torch.inference_mode(), matmul_precision("float32"):
            wav = torch.as_tensor(np.asarray(wav, np.float32),
                                  device=self.device)
            feats = (self.fbank(wav[None]) - self._cmvn[0]) / self._cmvn[1]
            return self.model(feats)[0]

    def _decode_window(self, wav: np.ndarray):
        logits = self.logits(wav).cpu().numpy()
        return greedy_decode(logits, self.frame_dur_s)

    def transcribe(self, wav: np.ndarray) -> dict:
        """Sliding-window decode at the trained window length (the encoder's
        position encoding does not carry past the positions it saw in
        training): ``wav_len`` windows with 0.5 s overlap, the last one
        zero-padded; each token belongs to the window that owns its
        midpoint (every instant is owned once), its timestamps offset to
        global time."""
        fs = self.sample_rate
        win = int(self.window_s * fs)
        if wav.shape[0] <= win:
            return tokens_to_asr_result(self._decode_window(wav), self.vocab)
        ovl = int(self.overlap_s * fs)
        step = win - ovl
        half_ovl_s = self.overlap_s / 2.0
        tokens = []
        n_windows = -(-max(wav.shape[0] - ovl, 1) // step)
        for k in range(n_windows):
            s0 = k * step
            piece = wav[s0:s0 + win]
            if piece.shape[0] < win:
                piece = np.pad(piece, (0, win - piece.shape[0]))
            t0 = s0 / fs
            lo = t0 + (half_ovl_s if k > 0 else 0.0)
            hi = t0 + step / fs + half_ovl_s if k < n_windows - 1 \
                else wav.shape[0] / fs
            for tok, st, ed in self._decode_window(piece):
                mid = t0 + 0.5 * (st + ed)
                if lo <= mid < hi:
                    tokens.append((tok, t0 + st, t0 + ed))
        return tokens_to_asr_result(tokens, self.vocab)
