"""Single/pair speaker-verification inference CLI on a CUDA card (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/infer_sv.py`` (reference:
speakerlab/bin/infer_sv.py:213-317), with the same flags plus ``--device``:
resolve a pretrained model id; per wav: load -> 16 kHz mono -> fbank with
mean-norm -> model, one embed call at batch 1 on the whole utterance; save
.npy embeddings; with exactly two wavs print the cosine and the verdict.

Usage:
  python -m speaker3d_tpu_torch.cli.infer_sv \
      --model_id iic/speech_eres2netv2_sv_zh-cn_16k-common \
      --wavs a.wav b.wav [--local_model_dir pretrained] [--save_dir embs] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Extract speaker embeddings.")
    p.add_argument("--model_id", required=True)
    p.add_argument("--wavs", nargs="+", required=True)
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--yes_or_no_threshold", type=float, default=0.5)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embed call; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import upload_batch
    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.device import resolve_device
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.ops.fbank import FbankConfig
    from speaker3d_tpu_torch.utils.fileio import load_audio

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    model = load_pretrained(args.model_id, args.local_model_dir)
    embed = build_embedding_fn(model, device=device, precision="highest")

    wav_paths = list(args.wavs)
    if (len(wav_paths) == 1
            and not wav_paths[0].lower().endswith((".wav", ".flac"))):
        # a single non-audio argument lists one wav path per line
        # (reference: bin/infer_sv.py:318-331)
        try:
            with open(wav_paths[0]) as f:
                wav_paths = [ln.strip() for ln in f if ln.strip()]
        except (UnicodeDecodeError, OSError) as e:
            raise SystemExit(
                "[ERROR]: Input should be a wav file or a wav list "
                f"(could not read {wav_paths[0]!r} as a list: {e})")
        print(f"[INFO] wav list with {len(wav_paths)} entries")

    embs = []
    for wav_path in wav_paths:
        wav = load_audio(wav_path, obj_fs=16000)
        if wav.shape[1] < FbankConfig().frame_length:
            raise SystemExit(f"[ERROR]: {wav_path} is shorter than one fbank "
                             f"frame ({wav.shape[1]} samples)")
        emb = embed(upload_batch(wav, device))[0].cpu().numpy()
        embs.append(emb)
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(wav_path))[0]
            np.save(os.path.join(args.save_dir, f"{base}.npy"), emb)
            print(f"[INFO] embedding of {wav_path} saved")

    if len(embs) == 2:
        a, b = embs
        score = float(np.dot(a, b) /
                      (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        verdict = "yes" if score >= args.yes_or_no_threshold else "no"
        print(f"[INFO] cosine similarity: {score:.5f}")
        print(f"[INFO] same speaker: {verdict}")


if __name__ == "__main__":
    main()
