"""Detect sequential-speaker boundaries from extracted embeddings.

The counterpart of ``egs/split_sequential_speakers/detect_boundaries.py``
(the JAX package's entry point for it), with the same flags and JSON output
plus ``--device``: given per-utterance embeddings of a recording session
known to hold N speakers speaking SEQUENTIALLY (e.g. interview turns
recorded as numbered utterances), place the N-1 boundaries: start from equal
theoretical split points and refine each locally by cosine to the segment
centres or by GMM separation (``diar/boundaries.py``). Embeddings are
ordered by sorted utterance key.

``--device`` is resolved as in every entry point of the package (CUDA
unless ``cpu`` is asked for, raising without a card), so one command line
serves the whole workflow after ``extract``/``extract_ssl``; the arithmetic
itself stays on the host in numpy (the embeddings' dtype, float32 from the
extract CLIs, as the JAX script computes it; the GMMs in ``diar/gmm.py``).

Usage:
  python -m speaker3d_tpu_torch.cli.detect_boundaries --emb exp/embeddings \
      --num_speakers 2 [--method cosine|gmm] [--boundary_window 10] \
      [--out boundaries.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--emb", required=True,
                   help="embeddings dir (npy per utt or kaldi-style ark)")
    p.add_argument("--num_speakers", type=int, required=True)
    p.add_argument("--method", choices=["cosine", "gmm"], default="cosine")
    p.add_argument("--boundary_window", type=int, default=10)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the workflow; 'cpu' must be asked "
                        "for (the boundaries are host arithmetic)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    from speaker3d_tpu_torch.diar.boundaries import detect_speaker_boundaries
    from speaker3d_tpu_torch.eval.scoring import load_embeddings

    embs = load_embeddings(args.emb)
    if not embs:
        raise FileNotFoundError(f"no embeddings under {args.emb}")
    keys = sorted(embs)
    mat = np.stack([np.asarray(embs[k]).reshape(-1) for k in keys])
    boundaries = detect_speaker_boundaries(
        mat, args.num_speakers, method=args.method,
        boundary_window=args.boundary_window)

    edges = [0] + boundaries + [len(keys)]
    segments = [{"speaker": i, "first_utt": keys[a], "last_utt": keys[b - 1],
                 "num_utts": b - a}
                for i, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
    result = {"num_utts": len(keys), "num_speakers": args.num_speakers,
              "method": args.method, "boundaries": boundaries,
              "segments": segments}
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"boundaries -> {args.out}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
