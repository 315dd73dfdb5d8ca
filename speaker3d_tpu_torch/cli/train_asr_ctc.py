"""CTC ASR trainer CLI (SAN-M encoder + CTC head, ``asr/ctc.py``) on one
CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/train_asr_ctc.py``: build the config
(YAML + ``--key=value`` overrides, written to ``exp_dir/config.yaml``); the
vocabulary from the training texts (sorted, id 0 the CTC blank), written to
``exp_dir/vocab.json``; the global CMVN from the first 64 sorted
utterances cut to ``wav_len``, through the fbank without mean-norm, to
``exp_dir/cmvn.npy``; recover from the experiment's latest checkpoint;
then per epoch the batches in the JAX CLI's order (sorted keys shuffled by
``random.Random(seed + epoch)``, crops drawn from
``np.random.default_rng(seed * 1000 + epoch)``, labels zero-padded to the
corpus's longest text), the train step (the fbank kernel on the waveform in
every step), one ``train_epoch.log`` line and one checkpoint in the JAX
trainer's layout (``train_state.ckpt``: the Flax ``params`` tree,
``adam_m``, ``adam_v``, ``step``), which both packages' ``CTCTranscriber``
and trainers read.

Usage:
  python -m speaker3d_tpu_torch.cli.train_asr_ctc --config configs/asr_ctc.yaml \
      [--device cuda] [--any_yaml_key=value ...]

Config keys: exp_dir, data (CSV with ID,wav,text; text is space-separated
tokens), sample_rate, n_mels, wav_len, batch_size, num_epoch, the LR
schedule, model.args (``SANMCTC`` without vocab_size). Transcribe with the
experiment through ``python -m speaker3d_tpu_torch.cli.transcribe_diarization
--asr_exp_dir <exp_dir>``.

Deliberate differences from the JAX CLI: the initial weights draw from a
torch generator seeded by ``--seed`` with Flax's default distributions
(the JAX PRNG stream cannot be reproduced); one card (data-parallel
training over several cards is ROADMAP.md M14).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from speaker3d_tpu_torch.cli.train_vad import FSMN_CPU_THREADS
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.utils.fileio import load_audio
from speaker3d_tpu_torch.utils.threads import cpu_threads

CMVN_UTTERANCES = 64
MULTI_CARD_NOT_PORTED = ("data-parallel CTC training over several cards is "
                         "ROADMAP.md M14; the trainer runs on one card")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the CTC ASR")
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the train step; 'cpu' must be "
                        "asked for")
    args, overrides = p.parse_known_args(argv)
    return args, overrides


def build_vocab(rows: Dict[str, dict]) -> List[str]:
    """The sorted set of the texts' tokens; token id = index + 1."""
    return sorted({tok for r in rows.values()
                   for tok in str(r["text"]).split()})


def ctc_batches(rows: Dict[str, dict], tok2id: Dict[str, int], *,
                batch_size: int, wav_len: int, sample_rate: int, seed: int,
                epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch's batches of the JAX CLI: ``{'wavs' [B, wav_len] float32,
    'labels' [B, U] int32 zero-padded to the longest text, 'label_lens' [B]
    int32}``; a crop at a random offset when an utterance is longer than
    ``wav_len``, zero padding when shorter; the last partial batch
    dropped."""
    keys = sorted(rows)
    max_u = max(len(str(rows[k]["text"]).split()) for k in keys)

    def load_sample(key, rng):
        wav = load_audio(rows[key]["wav"], obj_fs=sample_rate)[0]
        if wav.shape[0] >= wav_len:
            s = rng.integers(0, wav.shape[0] - wav_len + 1)
            wav = wav[s:s + wav_len]
        else:
            wav = np.pad(wav, (0, wav_len - wav.shape[0]))
        toks = [tok2id[t] for t in str(rows[key]["text"]).split()]
        labels = np.zeros(max_u, np.int32)
        labels[:len(toks)] = toks
        return wav.astype(np.float32), labels, np.int32(len(toks))

    order = list(keys)
    random.Random(seed + epoch).shuffle(order)
    order = order[:(len(keys) // batch_size) * batch_size]
    rng = np.random.default_rng(seed * 1000 + epoch)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        samples = [load_sample(k, rng) for k in order[i:i + batch_size]]
        yield {"wavs": np.stack([s[0] for s in samples]),
               "labels": np.stack([s[1] for s in samples]),
               "label_lens": np.asarray([s[2] for s in samples], np.int32)}


def global_cmvn(rows: Dict[str, dict], fbank, *, wav_len: int,
                sample_rate: int) -> np.ndarray:
    """[2, n_mels] float32: the mean and the standard deviation + 1e-6 of
    the fbank frames of the first ``CMVN_UTTERANCES`` sorted utterances,
    each cut to ``wav_len`` samples."""
    stats = []
    for k in sorted(rows)[:CMVN_UTTERANCES]:
        wav = load_audio(rows[k]["wav"], obj_fs=sample_rate)[0][:wav_len]
        stats.append(fbank(torch.from_numpy(wav)[None])[0].cpu().numpy())
    stats = np.concatenate(stats, axis=0)
    return np.stack([stats.mean(axis=0),
                     stats.std(axis=0) + 1e-6]).astype(np.float32)


def main(argv=None):
    from speaker3d_tpu_torch.asr.ctc import (
        CTCTrainConfig, SANMCTC, init_sanm_ctc_, make_ctc_train_step)
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank_count)
    from speaker3d_tpu_torch.train.vad_train import (
        init_adam_train_state, load_state_tree, state_tree)
    from speaker3d_tpu_torch.utils.checkpoint import (
        Checkpointer, EpochCounter, EpochLogger)
    from speaker3d_tpu_torch.utils.config import build_config
    from speaker3d_tpu_torch.utils.fileio import load_data_csv

    args, overrides = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if process_rank_count()[1] > 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)
    config = build_config(args.config, overrides, copy_to_exp_dir=True)
    exp_dir = config["exp_dir"]
    os.makedirs(exp_dir, exist_ok=True)

    fs = config.get("sample_rate", 16000)
    wav_len = int(config.get("wav_len", 4.0) * fs)
    rows = load_data_csv(config["data"])
    vocab = build_vocab(rows)
    tok2id = {t: i + 1 for i, t in enumerate(vocab)}  # 0 = CTC blank
    with open(os.path.join(exp_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)

    batch_size = config.get("batch_size", 16)
    step_per_epoch = max(len(rows) // batch_size, 1)
    cfg = CTCTrainConfig(
        min_lr=config.get("min_lr", 1e-5),
        max_lr=config.get("max_lr", 2e-3),
        warmup_epoch=config.get("warmup_epoch", 1),
        fix_epoch=config.get("num_epoch", 20),
        step_per_epoch=step_per_epoch,
        weight_decay=config.get("weight_decay", 1e-6))

    model = SANMCTC(vocab_size=len(vocab),
                    **config.get("model", {}).get("args", {}))
    init_sanm_ctc_(model, torch.Generator().manual_seed(args.seed))
    # global CMVN (Paraformer's am.mvn convention): per-utterance mean-norm
    # would tie every frame's features to the silence in its window, which
    # breaks the transcriber's sliding windows
    fbank = KaldiFbank(FbankConfig(sample_rate=fs,
                                   num_mel_bins=config.get("n_mels", 80)),
                       mean_norm=False, device=device)
    cmvn = global_cmvn(rows, fbank, wav_len=wav_len, sample_rate=fs)
    np.save(os.path.join(exp_dir, "cmvn.npy"), cmvn)
    cmvn_t = torch.as_tensor(cmvn, device=device)

    def feature_fn(wavs):
        return (fbank(wavs) - cmvn_t[0]) / cmvn_t[1]

    state = init_adam_train_state(model, device)
    train_step = make_ctc_train_step(cfg, feature_fn=feature_fn)

    epoch_counter = EpochCounter(config.get("num_epoch", 20))
    checkpointer = Checkpointer(os.path.join(exp_dir, "models"),
                                recoverables={"epoch_counter": epoch_counter})
    recovered = checkpointer.recover_if_possible()
    if recovered is not None and "train_state" in recovered:
        load_state_tree(state, recovered["train_state"])
        print(f"recovered from epoch {recovered['__meta__']['epoch']}")
    logger = EpochLogger(os.path.join(exp_dir, "train_epoch.log"))

    # the CPU loop's small ops synchronise torch's thread pool at every op
    # (utils/threads.py): at most as many threads as the FSMN trainers'
    threads = (cpu_threads(min(torch.get_num_threads(), FSMN_CPU_THREADS))
               if device.type == "cpu" else contextlib.nullcontext())
    with threads:
        for epoch in epoch_counter:
            t0 = time.time()
            losses = []
            timed = _TimedIter(device_prefetch(ctc_batches(
                rows, tok2id, batch_size=batch_size, wav_len=wav_len,
                sample_rate=fs, seed=args.seed, epoch=epoch), device))
            clock = _StepClock(device)
            for batch in timed:
                clock.mark()
                losses.append(train_step(state, batch)["loss"])
            clock.mark()
            timed.close()
            if not losses:
                continue
            avg = float(np.mean([float(v) for v in losses]))
            logger.log_stats({"epoch": epoch,
                              "time_s": round(time.time() - t0, 1)},
                             {"avg_loss": avg})
            print(f"epoch {epoch} avg_loss {avg:.4f}", flush=True)
            print_epoch_summary(epoch, clock, timed, batch_size,
                                time.time() - t0, device)
            checkpointer.save_checkpoint(epoch,
                                         {"train_state": state_tree(state)})


if __name__ == "__main__":
    main()
