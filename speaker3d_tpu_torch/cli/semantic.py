"""Semantic-speaker CLIs on one card: dialogue detection and speaker-turn
detection.

The counterpart of ``speaker3d_tpu/cli/semantic.py``, with its flags,
defaults and printed lines, plus ``--device``: JSONL in (dialogue lines
``{"text": str, "label": 0|1}``, turn lines ``{"text": str, "labels": [0|1
per character]}``), BERT fine-tuning (``semantic/bert.py``: fp32 with TF32
off, decoupled AdamW with a linear warm-up over a tenth of the first epoch
and a linear decay to 0; each batch copied to the card ahead of its step,
``data/prefetch.py``), accuracy / precision / recall / F1 over the eval
split in ``exp_dir/metrics.json``.

As in the JAX CLI: the char-level tokenizer built from the training texts
(``CharTokenizer``), or with ``--pretrained DIR`` the directory's tokenizer
through ``transformers.AutoTokenizer`` (imported in that branch only) and
its weights; ``np.random.default_rng(0)`` permutations per epoch over the
first ``n = floor(len / B) * B`` examples; the ``epoch N: loss X`` and
``eval: {...}`` lines; eval in batches of ``--batch_size``. Besides, each
epoch prints the port trainers' ``epoch N: S steps of B, step X ms ...``
line (CUDA events on the card; peak memory).

Usage:
  python -m speaker3d_tpu_torch.cli.semantic dialogue --train train.jsonl \\
      --eval eval.jsonl --exp_dir exp/sem [--pretrained DIR] [--epochs 3] \\
      [--device cuda]
  python -m speaker3d_tpu_torch.cli.semantic turn --train ... --eval ...

Deliberate difference from the JAX CLI: without ``--pretrained`` the
initial weights draw Flax's distributions from a torch generator seeded
with 0 (``semantic/bert.py::init_bert_``); the JAX CLI draws from
``PRNGKey(0)``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device

MULTI_CARD_NOT_PORTED = ("data-parallel BERT fine-tuning over several cards "
                         "is ROADMAP.md M14; the trainer runs on one card")


class CharTokenizer:
    """Char-level fallback tokenizer (vocab built from training data)."""

    def __init__(self, texts, max_vocab=8000):
        from collections import Counter

        counts = Counter(c for t in texts for c in t)
        self.vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
        for ch, _ in counts.most_common(max_vocab - len(self.vocab)):
            self.vocab[ch] = len(self.vocab)

    @property
    def vocab_size(self):
        return max(len(self.vocab), 5)

    def __call__(self, text, max_length):
        ids = [2] + [self.vocab.get(c, 1) for c in text[:max_length - 2]] + [3]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        return ids + [0] * pad, mask + [0] * pad


def pretrained_tokenizer(path: str):
    """(tokenizer(text, max_length) -> (ids, mask), vocab size) of a local
    Hugging Face tokenizer directory: ``[CLS]``, the tokens, ``[SEP]``,
    truncated and padded to ``max_length``."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path)

    def tokenizer(text, max_length):
        enc = tok(text, max_length=max_length, truncation=True,
                  padding="max_length")
        return enc["input_ids"], enc["attention_mask"]

    return tokenizer, tok.vocab_size


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def encode(rows, tokenizer, max_length, token_level):
    ids, masks, labels = [], [], []
    for row in rows:
        i, m = tokenizer(row["text"], max_length)
        ids.append(i)
        masks.append(m)
        if token_level:
            lab = [-100] + list(row["labels"][:max_length - 2])
            lab += [-100] * (max_length - len(lab))
            labels.append(lab)
        else:
            labels.append(int(row["label"]))
    return (np.asarray(ids, np.int32), np.asarray(masks, np.int32),
            np.asarray(labels, np.int32))


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["dialogue", "turn"])
    p.add_argument("--train", required=True)
    p.add_argument("--eval", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the train step and the evaluation; "
                        "'cpu' must be asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank_count)
    from speaker3d_tpu_torch.semantic.bert import (
        SemanticTrainConfig, build_model, classification_metrics,
        make_semantic_train_step)
    from speaker3d_tpu_torch.train.vad_train import init_adam_train_state

    args = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if process_rank_count()[1] > 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)
    os.makedirs(args.exp_dir, exist_ok=True)
    token_level = args.task == "turn"

    train_rows = load_jsonl(args.train)
    eval_rows = load_jsonl(args.eval)
    if args.pretrained:
        tokenizer, vocab_size = pretrained_tokenizer(args.pretrained)
    else:
        ct = CharTokenizer([r["text"] for r in train_rows])
        tokenizer, vocab_size = ct, ct.vocab_size

    model = build_model("token" if token_level else "sequence",
                        pretrained_dir=args.pretrained,
                        vocab_size=vocab_size, hidden_size=args.hidden_size,
                        num_hidden_layers=args.num_layers,
                        num_attention_heads=max(2, args.hidden_size // 64),
                        device=device)

    tr = encode(train_rows, tokenizer, args.max_seq_length, token_level)
    ev = encode(eval_rows, tokenizer, args.max_seq_length, token_level)
    n = (len(tr[0]) // args.batch_size) * args.batch_size
    steps_per_epoch = max(n // args.batch_size, 1)
    cfg = SemanticTrainConfig(lr=args.lr,
                              total_steps=steps_per_epoch * args.epochs,
                              warmup_steps=steps_per_epoch // 10)
    state = init_adam_train_state(model, device)
    step = make_semantic_train_step(model, cfg, token_level)

    def to_device(x):
        return torch.from_numpy(x).to(device, torch.int64)

    def batches(order):
        for s in range(0, n, args.batch_size):
            idx = order[s:s + args.batch_size]
            yield {"input_ids": tr[0][idx].astype(np.int64),
                   "attention_mask": tr[1][idx].astype(np.int64),
                   "labels": tr[2][idx].astype(np.int64)}

    rng = np.random.default_rng(0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for epoch in range(args.epochs):
        order = rng.permutation(len(tr[0]))[:n]
        t0, losses = time.time(), []
        timed = _TimedIter(device_prefetch(batches(order), device))
        clock = _StepClock(device)
        for batch in timed:
            clock.mark()
            losses.append(step(state, batch)["loss"])
        clock.mark()
        losses = [float(x) for x in losses]  # one wait, after the epoch
        print(f"epoch {epoch+1}: loss {np.mean(losses):.4f}")
        print_epoch_summary(epoch + 1, clock, timed, args.batch_size,
                            time.time() - t0, device)

    # eval
    preds = []
    with torch.inference_mode(), matmul_precision("float32", device):
        for s in range(0, len(ev[0]), args.batch_size):
            logits = model(to_device(ev[0][s:s + args.batch_size]),
                           to_device(ev[1][s:s + args.batch_size]))
            preds.append(logits.argmax(dim=-1).cpu().numpy())
    preds = np.concatenate(preds)
    m = classification_metrics(ev[2], preds)
    with open(os.path.join(args.exp_dir, "metrics.json"), "w") as f:
        json.dump(m, f, indent=2)
    print("eval:", m)


if __name__ == "__main__":
    main()
