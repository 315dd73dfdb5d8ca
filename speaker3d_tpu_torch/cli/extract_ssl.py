"""SSL embedding extraction CLI.

The counterpart of ``speaker3d_tpu/cli/extract_ssl.py`` (reference:
speakerlab/bin/extract_ssl.py), with its flags plus ``--device``: load the
SSL experiment's latest checkpoint (either package's trainer), take the
TEACHER's backbone only, in eval mode, and embed each utterance of the
wav.scp at batch 1 through the linear mel spectrogram (the backbone takes
the log and the instance norm itself), in fp32 with TF32 off; write
``embeddings_{rank}.npz`` (the rank's shard of the sorted keys).

Usage:
  python -m speaker3d_tpu_torch.cli.extract_ssl --exp_dir exp/rdino \
      --data wav.scp --out_dir exp/rdino/embeddings [--variant rdino] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def load_teacher_embedder(exp_dir: str, variant: str,
                          device=DEFAULT_DEVICE) -> Callable:
    """``embed(wav [n] float32) -> [D] numpy``: the experiment's teacher
    backbone at batch 1 on ``device``."""
    from speaker3d_tpu_torch.cli.train_ssl import build_ssl_model
    from speaker3d_tpu_torch.compat.flax_convert import state_dict_from_flax
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.ops.melspec import MelSpecConfig, MelSpectrogram
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.config import build_config

    dev = resolve_device(device)
    config = build_config(os.path.join(exp_dir, "config.yaml"))
    backbone = build_ssl_model(variant, config).backbone
    states = Checkpointer(os.path.join(exp_dir, "models")).recover_if_possible()
    if states is None or "ssl_state" not in states:
        raise FileNotFoundError(f"no SSL checkpoint under {exp_dir}")
    teacher = states["ssl_state"]["teacher"]
    variables = {"params": teacher["params"]["backbone"],
                 "batch_stats": teacher.get("batch_stats", {}).get(
                     "backbone", {})}
    backbone.load_state_dict(state_dict_from_flax(
        variables, like=backbone.state_dict()), strict=True)
    backbone.to(dev).eval()
    melspec = MelSpectrogram(MelSpecConfig(n_mels=config.get("n_mels", 80)),
                             device=dev)

    def embed(wav) -> np.ndarray:
        x = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
        with torch.inference_mode(), matmul_precision("float32"):
            return backbone(melspec(x[None]))[0].cpu().numpy()

    return embed


def main(argv=None):
    from speaker3d_tpu_torch.eval.scoring import save_embeddings
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank, process_shard)
    from speaker3d_tpu_torch.utils.fileio import load_audio, load_wav_scp

    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--variant", choices=["rdino", "sdpn"], default="rdino")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device; 'cpu' must be asked for")
    args = p.parse_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group

    embed = load_teacher_embedder(args.exp_dir, args.variant, args.device)
    wav_scp = load_wav_scp(args.data)
    out = {}
    for utt in process_shard(sorted(wav_scp)):
        out[utt] = embed(load_audio(wav_scp[utt], obj_fs=16000)[0])
    os.makedirs(args.out_dir, exist_ok=True)
    save_embeddings(os.path.join(
        args.out_dir, f"embeddings_{process_rank()}.npz"), out)
    print(f"wrote {len(out)} teacher-backbone embeddings")


if __name__ == "__main__":
    main()
