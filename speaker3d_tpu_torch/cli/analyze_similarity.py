"""Embedding similarity analysis across speakers/datasets.

The counterpart of ``speaker3d_tpu/cli/analyze_similarity.py`` (reference
fork: egs/mix_adult_kid/sv-eres2netv2/
compute_utterance_similarities_analysis.py + analyze_speaker_similarity.py),
with the same flags and outputs plus ``--device``: from extracted
embeddings, build per-speaker centroids, compute the full cosine similarity
matrix, report pairs above a threshold with a dataset-level breakdown
(cross- vs within-dataset), and write ``similarity_matrix.npy``,
``speaker_similarity.json`` and a CSV of the top pairs. ``--level utt``
analyzes raw utterance embeddings instead of speaker centroids.

The N x N cosine matrix is one fp32 product on ``--device`` with TF32 off
(``eval.scoring.pairwise_cosine_device``).

Inputs: --emb: a directory of <utt>.npy (cli/extract.py output) or an .npz
archive; --utt2spk: 'utt spk' mapping (omit to treat every utterance as its
own speaker); --dataset_map: optional 'spk dataset' mapping for the
cross-dataset breakdown (--prefix_as N uses the first N '_'-separated key
fields instead).

Usage:
  python -m speaker3d_tpu_torch.cli.analyze_similarity --emb emb/ \
      --out_dir out/ [--utt2spk utt2spk] [--level speaker|utt] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.scoring import load_embeddings, pairwise_cosine_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Speaker similarity analysis")
    p.add_argument("--emb", required=True,
                   help="embeddings dir of <utt>.npy or a .npz archive")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--utt2spk", default=None)
    p.add_argument("--dataset_map", default=None,
                   help="file with '<spk> <dataset>' lines")
    p.add_argument("--prefix_as", type=int, default=0,
                   help="infer dataset from first N '_' fields of the key")
    p.add_argument("--level", choices=["speaker", "utt"], default="speaker")
    p.add_argument("--min_similarity", type=float, default=0.5)
    p.add_argument("--max_results", type=int, default=100)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the cosine matrix; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    embs = load_embeddings(args.emb)
    if not embs:
        raise FileNotFoundError(f"no embeddings under {args.emb}")

    utt2spk = {}
    if args.utt2spk:
        with open(args.utt2spk) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    utt2spk[parts[0]] = parts[1]

    if args.level == "speaker":
        by_spk = {}
        for utt, e in embs.items():
            spk = utt2spk.get(utt, utt)
            by_spk.setdefault(spk, []).append(np.asarray(e).reshape(-1))
        keys = sorted(by_spk)
        mat = np.stack([np.mean(by_spk[k], axis=0) for k in keys])
        counts = {k: len(by_spk[k]) for k in keys}
    else:
        keys = sorted(embs)
        mat = np.stack([np.asarray(embs[k]).reshape(-1) for k in keys])
        counts = {k: 1 for k in keys}

    sim = np.asarray(pairwise_cosine_device(mat.astype(np.float32),
                                            device=device))
    np.save(os.path.join(args.out_dir, "similarity_matrix.npy"), sim)

    dataset_of = {}
    if args.dataset_map:
        spk_dataset = {}
        with open(args.dataset_map) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    spk_dataset[parts[0]] = parts[1]
        for k in keys:  # the map is keyed by speaker; at utt level route
            dataset_of[k] = spk_dataset.get(utt2spk.get(k, k))
        dataset_of = {k: v for k, v in dataset_of.items() if v is not None}
    elif args.prefix_as > 0:
        for k in keys:
            dataset_of[k] = "_".join(k.split("_")[: args.prefix_as])

    n = len(keys)
    iu, ju = np.triu_indices(n, k=1)
    vals = sim[iu, ju]
    order = np.argsort(-vals)
    high = []
    cross, within, unknown = 0, 0, 0
    for idx in order:
        v = float(vals[idx])
        if v < args.min_similarity:
            break
        a, b = keys[int(iu[idx])], keys[int(ju[idx])]
        da, db = dataset_of.get(a), dataset_of.get(b)
        if da is None or db is None:
            is_cross = False
            unknown += 1
        elif da != db:
            is_cross = True
            cross += 1
        else:
            is_cross = False
            within += 1
        if len(high) < args.max_results:
            high.append({"a": a, "b": b, "similarity": v,
                         "dataset_a": da, "dataset_b": db,
                         "cross_dataset": is_cross})

    above = int((vals >= args.min_similarity).sum())
    report = {
        "level": args.level,
        "num_entities": n,
        "num_utterances": int(sum(counts.values())),
        "min_similarity": args.min_similarity,
        "num_pairs_above_threshold": above,
        "num_cross_dataset_pairs": cross,
        "num_within_dataset_pairs": within,
        "num_unknown_dataset_pairs": unknown,
        "similarity_stats": {
            "mean": float(vals.mean()) if vals.size else None,
            "p95": float(np.percentile(vals, 95)) if vals.size else None,
            "max": float(vals.max()) if vals.size else None,
        },
        "high_similarity_pairs": high,
        "keys": keys,
    }
    with open(os.path.join(args.out_dir, "speaker_similarity.json"), "w") as f:
        json.dump(report, f, indent=2)

    with open(os.path.join(args.out_dir, "similarity_analysis.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["a", "b", "similarity", "dataset_a", "dataset_b",
                    "cross_dataset"])
        for row in high:
            w.writerow([row["a"], row["b"], f"{row['similarity']:.4f}",
                        row["dataset_a"], row["dataset_b"],
                        row["cross_dataset"]])

    print(f"{n} {args.level}s, {above} pairs >= {args.min_similarity} "
          f"({cross} cross-dataset) -> {args.out_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
