"""Closed-set label prediction and accuracy CLI (language identification).

The counterpart of ``speaker3d_tpu/cli/predict_label.py``, with its flags
and output plus ``--device``: load an experiment of either package's SV
trainer (the backbone, and the cosine classifier's rows ``cls_w`` of the
checkpoint's train state, cut to the label encoder's real classes), embed
each wav at batch 1 (the fbank kernel with mean-norm, the backbone with
fp32 products), take the class of the largest cosine, and score the
accuracy against an utt2label file.

Usage:
  python -m speaker3d_tpu_torch.cli.predict_label --exp_dir exp/lid \
      --data wav.scp [--utt2label utt2lang] [--out predictions.txt] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Tuple

import numpy as np

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data", required=True, help="wav.scp")
    p.add_argument("--utt2label", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embed call; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def load_classifier(exp_dir: str) -> Tuple[np.ndarray, Dict[int, str]]:
    """(the classifier's rows of the real classes, L2-normalised [C, D];
    class index -> label) of an experiment of either trainer."""
    from speaker3d_tpu_torch.data.processors import SpkLabelEncoder
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer

    states = Checkpointer(os.path.join(exp_dir, "models")
                          ).recover_if_possible()
    cls_w = np.asarray(states["train_state"]["cls_w"])
    encoder = SpkLabelEncoder()
    encoder.load(os.path.join(exp_dir, "label_encoder.pkl"))
    cls_w = cls_w[:len(encoder)]  # drop speed-perturb/padding classes
    wn = cls_w / np.maximum(np.linalg.norm(cls_w, axis=1, keepdims=True),
                            1e-12)
    return wn, encoder.ind2lab


def predict(embed: Callable, wn: np.ndarray, ind2lab: Dict[int, str],
            wav_scp: Dict[str, str]) -> Dict[str, str]:
    """{utt: label}: each wav embedded at batch 1 by ``embed([1, n]) ->
    [1, D]``, the argmax cosine against the rows of ``wn``."""
    from speaker3d_tpu_torch.utils.fileio import load_audio

    preds = {}
    for utt, path in wav_scp.items():
        wav = load_audio(path, obj_fs=16000)[0]
        emb = embed(wav[None])[0].cpu().numpy()
        emb = emb / max(np.linalg.norm(emb), 1e-12)
        preds[utt] = ind2lab[int(np.argmax(wn @ emb))]
    return preds


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import build_model_from_exp
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.utils.fileio import load_wav_scp

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    model, _ = build_model_from_exp(args.exp_dir)
    embed = build_embedding_fn(model, device=args.device, precision="high",
                               mean_norm=True)
    wn, ind2lab = load_classifier(args.exp_dir)
    utt2label = load_wav_scp(args.utt2label) if args.utt2label else None
    preds = predict(embed, wn, ind2lab, load_wav_scp(args.data))

    correct = total = 0
    for utt, pred in preds.items():
        if utt2label is not None and utt in utt2label:
            total += 1
            correct += int(pred == utt2label[utt])
    if args.out:
        with open(args.out, "w") as f:
            for utt, lab in preds.items():
                f.write(f"{utt} {lab}\n")
    if total:
        print(f"accuracy: {100.0 * correct / total:.2f}% ({correct}/{total})")
    else:
        for utt, lab in list(preds.items())[:20]:
            print(utt, lab)


if __name__ == "__main__":
    main()
