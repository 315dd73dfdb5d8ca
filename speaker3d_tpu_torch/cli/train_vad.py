"""DFSMN VAD trainer CLI on one CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/train_vad.py``: build the config
(YAML + ``--key=value`` overrides, written to ``exp_dir/config.yaml``), the
synthetic speech/background dataset and the threaded loader, the model;
recover from the experiment's latest checkpoint; then per epoch the train
loop (the fbank kernel on the waveform in every step), one
``train_epoch.log`` line and one checkpoint in the JAX trainer's layout
(``train_state.ckpt``: the Flax ``params`` tree, ``adam_m``, ``adam_v``,
``step``), which both packages' ``load_vad_exp`` and trainers read.

Usage:
  python -m speaker3d_tpu_torch.cli.train_vad --config configs/fsmn_vad.yaml \
      [--device cuda] [--any_yaml_key=value ...]

Config keys: exp_dir, speech (csv/scp/list of speech wavs), noise (optional
scp), window_dur, batch_size, num_epoch, the LR schedule, model.args
(``FSMNVad``). Diarize with the experiment through ``python -m
speaker3d_tpu_torch.cli.infer_diarization --vad_exp_dir <exp_dir>``.

Deliberate differences from the JAX CLI: the initial weights draw from a
torch generator seeded by ``--seed`` with Flax's default distributions
(the JAX PRNG stream cannot be reproduced); one card (data-parallel
training over several cards is ROADMAP.md M14).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.utils.config import build_config
from speaker3d_tpu_torch.utils.threads import cpu_threads

# the tests' tiny VAD trainer on 8 cores: 7.0 s at 8 threads, 4.6 s at 2;
# with 8 busy processes 74.2 s at 8 threads, 12.0 s at 2, 9.4 s at 1
FSMN_CPU_THREADS = 2
MULTI_CARD_NOT_PORTED = ("data-parallel FSMN training over several cards "
                         "is ROADMAP.md M14; the trainer runs on one card")


def get_args(argv=None, description="Train the DFSMN VAD"):
    parser = argparse.ArgumentParser(description=description)
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


def setup(argv, description):
    """(args, device, config) with the checks every FSMN trainer makes
    first: the device, one card, the seed."""
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank_count)
    from speaker3d_tpu_torch.utils.misc import set_seed

    args, overrides = get_args(argv, description)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if process_rank_count()[1] > 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)
    set_seed(args.seed)
    config = build_config(args.config, overrides, copy_to_exp_dir=True)
    os.makedirs(config["exp_dir"], exist_ok=True)
    return args, device, config


def train_fsmn(args, device, config, dataset, model, make_step,
               default_batch: int) -> None:
    """The FSMN trainers' loop: ``model`` initialised from ``--seed``,
    ``make_step(cfg, feature_fn)`` run over ``dataset`` for the config's
    epochs, with recovery, logs and checkpoints."""
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.dataset import BatchLoader
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.train.vad_train import (
        VadTrainConfig, init_adam_train_state, load_state_tree, state_tree)
    from speaker3d_tpu_torch.utils.checkpoint import (
        Checkpointer, EpochCounter, EpochLogger)
    from speaker3d_tpu_torch.utils.misc import fetch_mean
    from speaker3d_tpu_torch.utils.preemption import (
        GracefulShutdown, save_preemption_checkpoint)
    from speaker3d_tpu_torch.utils.profiling import StepTracer

    exp_dir = config["exp_dir"]
    loader = BatchLoader(dataset, batch_size=config.get("batch_size",
                                                        default_batch),
                         num_workers=config.get("num_workers", 4),
                         seed=args.seed)
    step_per_epoch = max(len(loader), 1)
    cfg = VadTrainConfig(
        min_lr=config.get("min_lr", 1e-5),
        max_lr=config.get("max_lr", 1e-3),
        warmup_epoch=config.get("warmup_epoch", 1),
        fix_epoch=config.get("num_epoch", 10),
        step_per_epoch=step_per_epoch,
        weight_decay=config.get("weight_decay", 1e-5),
    )
    # absolute log-mel features (no mean-norm), as diar/dnn_vad.py and
    # diar/dnn_seg.py compute them at inference
    fbank = KaldiFbank(FbankConfig(sample_rate=config.get("sample_rate",
                                                          16000),
                                   num_mel_bins=model.feat_dim),
                       mean_norm=False, device=device)
    lecun_init_(model, torch.Generator().manual_seed(args.seed))
    state = init_adam_train_state(model, device)
    train_step = make_step(cfg, feature_fn=fbank)

    epoch_counter = EpochCounter(config.get("num_epoch", 10))
    checkpointer = Checkpointer(os.path.join(exp_dir, "models"),
                                recoverables={"epoch_counter": epoch_counter})
    recovered = checkpointer.recover_if_possible()
    if recovered is not None and "train_state" in recovered:
        load_state_tree(state, recovered["train_state"])
        print(f"recovered from epoch {recovered['__meta__']['epoch']}")

    logger = EpochLogger(os.path.join(exp_dir, "train_epoch.log"))
    log_every = config.get("log_batch_freq", 10)
    shutdown = GracefulShutdown()
    preempted = False
    tracer = StepTracer(args.profile_dir, num_steps=args.profile_steps)
    global_step = 0
    # on the CPU the loop's small ops synchronise torch's thread pool at
    # every op: at most FSMN_CPU_THREADS threads (utils/threads.py)
    threads = (cpu_threads(min(torch.get_num_threads(), FSMN_CPU_THREADS))
               if device.type == "cpu" else contextlib.nullcontext())
    with threads:
        for epoch in epoch_counter:
            loader.set_epoch(epoch)
            t0 = time.time()
            losses, accs = [], []
            timed = _TimedIter(device_prefetch(loader, device))
            clock = _StepClock(device)
            for i, batch in enumerate(timed):
                clock.mark()
                tracer.before_step(global_step)
                metrics = train_step(state, batch)
                tracer.after_step(global_step, wait_for=metrics["loss"])
                global_step += 1
                if shutdown.poll():
                    preempted = True
                    break
                # device scalars, read once per epoch (or at a log line)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                if (i + 1) % log_every == 0:
                    print(f"epoch {epoch} step {i+1}/{step_per_epoch} "
                          f"loss {float(losses[-1]):.4f} "
                          f"acc {float(accs[-1]):.3f} "
                          f"lr {float(metrics['lr']):.6f}", flush=True)
            clock.mark()
            timed.close()
            if preempted:
                save_preemption_checkpoint(checkpointer, epoch_counter, epoch,
                                           {"train_state": state_tree(state)})
                break
            logger.log_stats(
                {"epoch": epoch, "time_s": round(time.time() - t0, 1),
                 "data_wait_s": round(timed.wait, 1)},
                {"avg_loss": fetch_mean(losses) if losses else None,
                 "avg_acc": fetch_mean(accs) if accs else None})
            print_epoch_summary(epoch, clock, timed, loader.batch_size,
                                time.time() - t0, device)
            checkpointer.save_checkpoint(epoch,
                                         {"train_state": state_tree(state)})
    tracer.close()
    shutdown.finalize(preempted)


def main(argv=None):
    from speaker3d_tpu_torch.data.dataset_vad import SyntheticVadDataset
    from speaker3d_tpu_torch.models.fsmn_vad import FSMNVad
    from speaker3d_tpu_torch.train.vad_train import make_vad_train_step

    args, device, config = setup(argv, "Train the DFSMN VAD")
    dataset = SyntheticVadDataset(
        speech=config["speech"],
        noise=config.get("noise"),
        sample_rate=config.get("sample_rate", 16000),
        window_dur=config.get("window_dur", 4.0),
        max_events=config.get("max_events", 3),
        min_event_dur=config.get("min_event_dur", 0.4),
        snr_range=tuple(config.get("snr_range", (0.0, 20.0))),
        seed=args.seed,
        size=config.get("dataset_size"),
    )
    model = FSMNVad(**config.get("model", {}).get("args", {}))
    train_fsmn(args, device, config, dataset, model, make_vad_train_step,
               default_batch=64)


if __name__ == "__main__":
    main()
