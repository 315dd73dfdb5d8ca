"""ASR-encoder-fused speaker training (train_para) on CUDA cards (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/train_para.py``: per step a FROZEN
Paraformer-style ASR encoder turns the acoustic features into [B, T,
d_model], and the speaker backbone and classifier train on that. The frozen
front (Kaldi fbank with a Hamming window, on a card the fbank kernel; LFR
stacking; the optional CMVN; the SAN-M encoder in eval mode under
``torch.no_grad``) is the ``feature_fn`` of the SV train step
(``train/sv_train.py``), so freezing is by construction: the encoder's
parameters never enter the optimizer state or the checkpoint, which holds
the backbone and the classifier in the JAX trainer's layout
(``train/sv_train.py::flax_state_tree``), so either package resumes the
other's experiment.

Encoder weights: ``encoder_ckpt`` when given, a funasr ``.pt/.pth/.bin/.pb``
(``compat/funasr_convert.py``) or a pickle of a Flax params tree with numpy
leaves; else Flax's default distributions drawn from a ``torch.Generator``
seeded with ``--seed`` + 7 (the JAX CLI draws from ``PRNGKey(seed + 7)``,
whose stream cannot be reproduced).

Usage:
  python -m speaker3d_tpu_torch.cli.train_para \\
      --config configs/eres2net_para.yaml [--device cuda] [--key=value ...]

The rest is ``cli/train.py``'s loop (``fit``): the loader, checkpoints and
recovery, SIGTERM, ``--profile_dir``, ``train_epoch.log`` and the ``epoch
N: ...`` summary, and its mesh (``train_mesh``): one process per card,
joined by ``init_multihost``, ``model_parallel`` splitting the classes,
rank 0 alone writing.
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

from speaker3d_tpu_torch.cli.train import (
    build_loader, build_model, fit, sv_train_config, train_mesh)
from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
from speaker3d_tpu_torch.compat.funasr_convert import load_funasr_encoder
from speaker3d_tpu_torch.data.processor_para import apply_lfr_device, load_cmvn
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_
from speaker3d_tpu_torch.models.sanm import SANMEncoder
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.parallel.mesh import init_multihost, is_main_process
from speaker3d_tpu_torch.train.sv_train import (
    flax_state_tree, init_sv_train_state, make_sv_train_step)
from speaker3d_tpu_torch.utils.builder import dynamic_import
from speaker3d_tpu_torch.utils.config import build_config
from speaker3d_tpu_torch.utils.misc import set_seed

FUNASR_SUFFIXES = (".pt", ".pth", ".bin", ".pb")


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a speaker model on frozen ASR-encoder features")
    parser.add_argument("--config", required=True)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device of the train step; 'cpu' must be "
                             "asked for")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of a window of "
                             "train steps (utils/profiling.py)")
    parser.add_argument("--profile_steps", type=int, default=5)
    args, overrides = parser.parse_known_args(argv)
    return args, overrides


class FrozenFrontend:
    """fbank -> LFR -> CMVN -> the encoder, with no gradient: wavs [B, L]
    on the device -> [B, ceil(T / lfr_n), d_model]."""

    def __init__(self, fbank: KaldiFbank, encoder: torch.nn.Module,
                 lfr_m: int, lfr_n: int, cmvn=None):
        self.fbank, self.encoder = fbank, encoder
        self.lfr_m, self.lfr_n, self.cmvn = lfr_m, lfr_n, cmvn

    def __call__(self, wavs):
        with torch.no_grad():
            feats = apply_lfr_device(self.fbank(wavs), self.lfr_m, self.lfr_n)
            if self.cmvn is not None:
                feats = (feats + self.cmvn[0]) * self.cmvn[1]
            return self.encoder(feats)


def load_encoder_weights(encoder: torch.nn.Module, ckpt: str) -> None:
    """``encoder_ckpt`` into ``encoder``: a funasr checkpoint by its suffix,
    else a pickled Flax params tree (numpy leaves)."""
    if ckpt.endswith(FUNASR_SUFFIXES):
        load_funasr_encoder(ckpt, encoder)
        return
    with open(ckpt, "rb") as f:
        params = pickle.load(f)
    encoder.load_state_dict(state_dict_from_flax(
        {"params": params}, like=encoder.state_dict()), strict=True)


def build_frozen_frontend(config, seed: int, device=DEFAULT_DEVICE) -> tuple:
    """(``FrozenFrontend`` on ``device``, the encoder's d_model, the crop
    length in samples)."""
    device = resolve_device(device)
    fs = config.get("sample_rate", 16000)
    n_mels = config.get("fbank_dim", 80)
    lfr_m, lfr_n = config.get("lfr_m", 7), config.get("lfr_n", 6)
    # Paraformer features use a Hamming window; the mean-norm follows the
    # recipe (the JAX CLI's notes)
    fbank = KaldiFbank(
        FbankConfig(sample_rate=fs, num_mel_bins=n_mels,
                    window_type=config.get("fbank_window", "hamming")),
        mean_norm=config.get("fbank_mean_nor", True), device=device)

    enc_cfg = config.get("asr_encoder", {}) or {}
    enc_cls = (dynamic_import(enc_cfg["obj"]) if "obj" in enc_cfg
               else SANMEncoder)
    enc_args = dict(enc_cfg.get("args", {}))
    enc_args.setdefault("input_dim", n_mels * lfr_m)
    encoder = enc_cls(**enc_args)
    if config.get("encoder_ckpt"):
        load_encoder_weights(encoder, config["encoder_ckpt"])
    else:
        lecun_init_(encoder, torch.Generator().manual_seed(seed + 7))
    encoder.to(device).eval().requires_grad_(False)

    cmvn = None
    if config.get("cmvn_file"):
        cmvn = torch.as_tensor(load_cmvn(config["cmvn_file"]), device=device)
    frontend = FrozenFrontend(fbank, encoder, lfr_m, lfr_n, cmvn)
    return frontend, int(encoder.d_model), int(config.get("wav_len", 3.0) * fs)


def main(argv=None):
    args, overrides = get_args(argv)
    init_multihost(device=args.device)
    device = resolve_device(args.device)
    set_seed(args.seed)
    config = build_config(args.config, overrides,
                          copy_to_exp_dir=is_main_process())
    os.makedirs(config["exp_dir"], exist_ok=True)
    mesh = train_mesh(config, device)
    dataset, loader, label_encoder = build_loader(
        config, args.seed, speed_pertub=False, wire="float32", mesh=mesh)

    frontend, d_model, _ = build_frozen_frontend(config, args.seed, device)
    config["model"].setdefault("args", {}).setdefault("feat_dim", d_model)
    model = build_model(config, args.seed)
    cfg = sv_train_config(config, dataset.num_classes, len(loader))
    train_step = make_sv_train_step(model, cfg, feature_fn=frontend,
                                    mesh=mesh)
    state = init_sv_train_state(model, cfg, seed=args.seed, mesh=mesh)
    fit(args, config, device, state, train_step, loader, label_encoder,
        tree_fn=flax_state_tree, warm_start=False, log_margin=False)


if __name__ == "__main__":
    main()
