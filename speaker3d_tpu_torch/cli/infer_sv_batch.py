"""Large-scale batch SV embedding extraction CLI on a CUDA card (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/infer_sv_batch.py`` (reference:
speakerlab/bin/infer_sv_batch.py), with the same flags plus ``--device``:
wav list in, per-wav embedding out (.npy per wav, one .npz archive or a
Kaldi ark + scp); each wav capped at 90 s and cut into 10 s circle-padded
chunks whose embeddings are averaged (:388-411); a wav that cannot be opened
is logged and skipped (:361-365); files shard across processes.

Usage:
  python -m speaker3d_tpu_torch.cli.infer_sv_batch --model_id ID \
      --wavs list.txt --out_dir embs [--out_type npy|npz|ark] [--device cuda]

``--exp_dir`` (a trained experiment of either trainer) replaces
``--model_id``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Batch speaker embedding extraction")
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2_sv_zh-cn_16k-common")
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--exp_dir", default=None,
                   help="a trained experiment instead of --model_id")
    p.add_argument("--wavs", required=True,
                   help="wav path, dir, or list file (one path per line)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--out_type", choices=["npy", "npz", "ark"],
                   default="npy",
                   help="'ark' = Kaldi binary ark+scp (the reference's "
                        "--feat_out_format ark, bin/infer_sv_batch.py:42)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--buckets", default=None,
                   help="comma-separated duration buckets in seconds "
                        "(e.g. '1.5,3,6,10'; last = chunk size); the final "
                        "partial chunk circle-pads to its smallest holding "
                        "bucket (see cli/extract --buckets)")
    p.add_argument("--nprocs", type=int, default=1,
                   help="local subprocess fan-out (utils/fanout.py); files "
                        "shard rank::nprocs")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embed call; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import (
        extract_embeddings, load_model, write_embeddings)
    from speaker3d_tpu_torch.cli.infer_diarization import collect_wavs
    from speaker3d_tpu_torch.device import resolve_device
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.parallel.mesh import init_multihost, process_shard
    from speaker3d_tpu_torch.utils.fanout import maybe_fanout

    args = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if maybe_fanout("speaker3d_tpu_torch.cli.infer_sv_batch", argv,
                    args.nprocs):
        return
    model = load_model(args.exp_dir, args.model_id, args.local_model_dir)

    scp = {}
    for p in process_shard(collect_wavs([args.wavs])):
        scp[os.path.splitext(os.path.basename(p))[0]] = p
    embed_fn = build_embedding_fn(model, device=device, precision="high")

    # decode failures: log + skip (reference: infer_sv_batch.py:361-365)
    good_scp = {}
    for utt, path in scp.items():
        try:
            with open(path, "rb") as f:
                f.read(4)
            good_scp[utt] = path
        except OSError as e:
            print(f"[WARNING] skipping {path}: {e}")

    buckets = ([float(s) for s in args.buckets.split(",")]
               if args.buckets else None)
    embs = extract_embeddings(embed_fn, good_scp, mode="chunked",
                              batch_size=args.batch_size,
                              bucket_seconds=buckets, device=device)
    if args.out_type == "npy":
        os.makedirs(args.out_dir, exist_ok=True)
        for utt, emb in embs.items():
            np.save(os.path.join(args.out_dir, f"{utt}.npy"), emb)
    else:
        write_embeddings(args.out_dir, embs, args.out_type)
    print(f"extracted {len(embs)} embeddings -> {args.out_dir}")


if __name__ == "__main__":
    main()
