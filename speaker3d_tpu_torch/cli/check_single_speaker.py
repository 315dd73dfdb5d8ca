"""Single-vs-multi speaker verdict CLI.

The counterpart of ``speaker3d_tpu/cli/check_single_speaker.py``
(reference: speakerlab/bin/check_single_speaker.py:96-146), with the same
flags plus ``--device``: VAD -> embeddings of sliding 1.5 s chunks within
the speech segments (the diarization pipeline, on ``--device``) ->
pairwise cosines (float64 on the host); single-speaker iff the minimum
pairwise cosine >= threshold (default 0.8). JSON output with segments,
min/mean cosine and pairwise similarities; batch mode over a directory.
``--exp_dir`` is refused: it reads the trainer's experiment layout
(ROADMAP.md, M12).

Usage:
  python -m speaker3d_tpu_torch.cli.check_single_speaker --wav a.wav \
      [--threshold 0.8] [--out result.json] [--device cuda]
  python -m speaker3d_tpu_torch.cli.check_single_speaker --src_dir wavs/ \
      --pattern '*.wav' --out_dir results/
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from speaker3d_tpu_torch.cli.extract import EXP_DIR_NOT_PORTED
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar.cluster import cosine_affinity


def check_single_speaker(wav_path, pipe, threshold=0.8):
    pipe(wav_path)  # VAD, chunking and embeddings (and a clustering)
    segments = pipe.last_vad_time or []
    embs = pipe.last_embeddings
    chunks = pipe.last_chunks or []

    if embs is None or len(embs) < 2:
        min_sim = mean_sim = 1.0
        pairs = []
    else:
        aff = cosine_affinity(embs)
        iu = np.triu_indices(aff.shape[0], 1)
        vals = aff[iu]
        min_sim = float(vals.min())
        mean_sim = float(vals.mean())
        pairs = [{"i": int(i), "j": int(j), "cosine": float(v),
                  "seg_i": {"start": chunks[i][0], "stop": chunks[i][1]},
                  "seg_j": {"start": chunks[j][0], "stop": chunks[j][1]}}
                 for i, j, v in zip(iu[0], iu[1], vals)]

    return {
        "wav_path": wav_path,
        "num_segments": len(segments),
        "segments": [{"start": float(s), "stop": float(e)}
                     for s, e in segments],
        "threshold": float(threshold),
        "min_pairwise_cosine": min_sim,
        "mean_pairwise_cosine": mean_sim,
        "is_single_speaker": bool(min_sim >= threshold),
        "pairwise_similarities": pairs,
    }


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Check if utterances are single-speaker")
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument("--wav")
    group.add_argument("--src_dir")
    p.add_argument("--pattern", default="*.wav")
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--out", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--model_id",
                   default="iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common")
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--exp_dir", default=None,
                   help="a trained experiment instead of --model_id "
                        "(not ported yet)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embeddings; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn

    args = get_args(argv)
    if args.exp_dir:
        raise SystemExit(EXP_DIR_NOT_PORTED)
    device = resolve_device(args.device)
    model = load_pretrained(args.model_id, args.local_model_dir)
    embed_fn = build_embedding_fn(model, device=device, precision="high")
    pipe = DiarizationPipeline(embed_fn, device=device)

    if args.wav:
        if args.wav.endswith((".list", ".txt")):
            with open(args.wav) as f:
                wavs = [line.strip() for line in f if line.strip()]
        else:
            wavs = [args.wav]
    else:
        wavs = sorted(glob.glob(os.path.join(args.src_dir, args.pattern)))

    results = []
    for w in wavs:
        r = check_single_speaker(w, pipe, args.threshold)
        results.append(r)
        verdict = "SINGLE" if r["is_single_speaker"] else "MULTI"
        print(f"{w}: {verdict} (min cos {r['min_pairwise_cosine']:.3f}, "
              f"mean {r['mean_pairwise_cosine']:.3f})")
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(w))[0]
            # per-file sidecar name as the reference's
            out_file = os.path.join(args.out_dir, f"{base}.single_spk.json")
            with open(out_file, "w") as f:
                json.dump(r, f, indent=2, ensure_ascii=False)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f, indent=2)
    return results


if __name__ == "__main__":
    main()
