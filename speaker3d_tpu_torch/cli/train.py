"""Supervised SV trainer CLI on CUDA cards (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/train.py``: build the config (YAML +
``--key=value`` overrides, written to ``exp_dir/config.yaml``), the dataset
and threaded loader, the model and classifier, the schedules; recover from
the experiment's latest checkpoint, or warm-start from ``init_exp_dir``
(model and classifier weights, optimizer and step reset); then per epoch
the train loop, one ``train_epoch.log`` line (with ``data_wait_s``, the
time the loop waited on the loader) and one checkpoint.

Usage:
  python -m speaker3d_tpu_torch.cli.train --config configs/eres2netv2.yaml \
      [--device cuda] [--any_yaml_key=value ...]
  torchrun --nproc_per_node 4 -m speaker3d_tpu_torch.cli.train \
      --config ... [--model_parallel=2] [--device cpu]

One process per card: ``init_multihost`` joins the processes that torchrun
(or ``SPEAKER3D_COORDINATOR_ADDRESS`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``)
describes, over ``nccl`` on the cards and ``gloo`` with ``--device cpu``.
The ``('data', 'model')`` mesh is sized as the JAX CLI sizes it, a node's
ranks taking the place of a host's devices (``train_mesh``), and must hold
every rank. ``batch_size`` is the global batch; each data row loads its
share, and ``model_parallel`` splits the classifier's classes. Rank 0
alone writes the config copy, the logs and the checkpoints. Deliberate
differences from the JAX CLI: the model's initial weights and the classifier
draw from torch generators seeded by ``--seed`` (the JAX PRNG stream cannot
be reproduced).
"""

from __future__ import annotations

import argparse
import math
import os
import random
import time
from typing import Optional

import torch

from speaker3d_tpu_torch.data.dataset import BatchLoader, WavSVDataset
from speaker3d_tpu_torch.data.prefetch import device_prefetch
from speaker3d_tpu_torch.data.processors import SpkLabelEncoder, SpkVeriAug, WavReader
from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
from speaker3d_tpu_torch.parallel.mesh import (
    Mesh, balanced_devices, init_multihost, is_main_process, make_mesh)
from speaker3d_tpu_torch.train.sv_train import (
    SVTrainConfig, init_sv_train_state, load_state_tree, make_sv_train_step,
    state_tree)
from speaker3d_tpu_torch.utils.builder import dynamic_import
from speaker3d_tpu_torch.utils.checkpoint import Checkpointer, EpochCounter, EpochLogger
from speaker3d_tpu_torch.utils.config import build_config
from speaker3d_tpu_torch.utils.misc import fetch_mean, set_seed
from speaker3d_tpu_torch.utils.preemption import (
    GracefulShutdown, save_preemption_checkpoint)
from speaker3d_tpu_torch.utils.profiling import StepTracer


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a speaker embedding model")
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


class _TimedIter:
    """Meters how long the consumer blocks on the prefetch queue: the host
    loader's share of the epoch wall."""

    def __init__(self, inner):
        self.it = iter(inner)
        self.wait = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.time()
        try:
            return next(self.it)
        finally:
            self.wait += time.time() - t

    def close(self):
        close = getattr(self.it, "close", None)
        if close is not None:
            close()


class _StepClock:
    """Step-start marks: CUDA events on the card (read once, after the
    epoch, so the loop never waits on the card), the host clock on the CPU.
    ``ms()`` gives the intervals between consecutive marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self):
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def print_epoch_summary(epoch: int, clock: _StepClock, timed: _TimedIter,
                        batch_size: int, wall_s: float,
                        device: torch.device) -> None:
    """The epoch's ``epoch N: ...`` line: steps, the median step interval
    and the first, samples/s, the data wait against the epoch's wall, and
    on the card the peak memory."""
    intervals = clock.ms()
    if not intervals:
        return
    step_ms = sorted(intervals)
    med = step_ms[len(step_ms) // 2]
    peak = (f", peak memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "")
    print(f"epoch {epoch}: {len(step_ms)} steps of {batch_size}, "
          f"step {med:.1f} ms (median; the first {intervals[0]:.1f}), "
          f"{batch_size / med * 1e3:.1f} samples/s, "
          f"data_wait_s {timed.wait:.2f} of {wall_s:.2f} s{peak}", flush=True)


def build_model(config, seed: int) -> torch.nn.Module:
    """The config's model, its initial weights drawn from torch's CPU
    generator seeded with ``seed`` (the global generator left as it was)."""
    model_cls = dynamic_import(config["model"]["obj"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return model_cls(**config["model"].get("args", {}))


def train_mesh(config, device) -> Mesh:
    """The trainer's ('data', 'model') mesh over the process group, sized as
    the JAX CLI sizes it with a node's ranks (torchrun's
    ``LOCAL_WORLD_SIZE``) as a host's devices: ``n_data = nodes *
    gcd(batch_size / nodes, ranks per node / model_parallel)``. One process
    with no group is a 1 x 1 mesh. A rank outside the mesh would idle, so a
    world larger than the mesh is refused."""
    world = torch.distributed.get_world_size() if (
        torch.distributed.is_available()
        and torch.distributed.is_initialized()) else 1
    n_model = config.get("model_parallel", 1)
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_nodes = max(1, world // n_local)
    per_node_batch = config.get("batch_size", 128) // n_nodes
    n_data = n_nodes * math.gcd(per_node_batch, max(n_local // n_model, 1))
    mesh = make_mesh(data=n_data, model=n_model,
                     devices=balanced_devices(n_data * n_model), device=device)
    if mesh.size != world:
        raise ValueError(
            f"the mesh {n_data}x{n_model} (batch_size "
            f"{config.get('batch_size', 128)}, model_parallel {n_model}) uses "
            f"{mesh.size} of the {world} processes; launch {mesh.size}")
    return mesh


def build_loader(config, seed: int, *, speed_pertub: bool = True,
                 wire: str = "int16", mesh: Optional[Mesh] = None) -> tuple:
    """(dataset, loader, label encoder) of the config's ``data`` CSV.
    ``speed_pertub`` and ``wire`` are the defaults of the config keys
    ``speed_pertub`` and ``wire_dtype`` ('int16' or 'float32'). On a
    ``mesh`` the loader yields this rank's data-row share of each global
    batch."""
    # every random draw of the data pipeline (speeds, crops, augmentation)
    # comes from this generator, seeded as the JAX CLI seeds the global one
    data_rng = random.Random(seed)
    wav_reader = WavReader(
        sample_rate=config.get("sample_rate", 16000),
        duration=config.get("wav_len", 3.0),
        speed_pertub=config.get("speed_pertub", speed_pertub), rng=data_rng)
    label_encoder = SpkLabelEncoder(config["data"])
    aug = SpkVeriAug(
        aug_prob=config.get("aug_prob", 0.0),
        noise_file=config.get("noise"), reverb_file=config.get("reverb"),
        rng=data_rng) if config.get("aug_prob", 0.0) > 0 else None
    dataset = WavSVDataset(config["data"], wav_reader, label_encoder, aug)

    wire = config.get("wire_dtype", wire)
    if wire not in ("float32", "int16"):
        raise ValueError(
            f"config key 'wire_dtype' must be 'float32' or 'int16', "
            f"got {wire!r}")
    n_data = 1 if mesh is None else mesh.shape["data"]
    batch = config.get("batch_size", 128)
    if batch % n_data:
        raise ValueError(f"batch_size {batch} is not divisible by the mesh's "
                         f"data axis ({n_data})")
    loader = BatchLoader(
        dataset, batch_size=batch // n_data,
        num_workers=config.get("num_workers", 8), seed=seed,
        process_index=0 if mesh is None else mesh.index("data"),
        process_count=n_data,
        wire_dtype=None if wire == "float32" else wire)
    return dataset, loader, label_encoder


def sv_train_config(config, num_classes: int,
                    step_per_epoch: int) -> SVTrainConfig:
    """The train step's settings from the config, as the JAX CLIs read
    them."""
    return SVTrainConfig(
        num_classes=num_classes,
        embedding_size=config.get("embedding_size", 192),
        momentum=config.get("momentum", 0.9),
        nesterov=config.get("nesterov", True),
        weight_decay=config.get("weight_decay", 1e-4),
        min_lr=config.get("min_lr", 1e-4),
        max_lr=config.get("max_lr", 0.2),
        warmup_epoch=config.get("warmup_epoch", 5),
        fix_epoch=config.get("num_epoch", 70),
        step_per_epoch=max(step_per_epoch, 1),
        initial_margin=config.get("initial_margin", 0.0),
        final_margin=config.get("final_margin", 0.3),
        increase_start_epoch=config.get("increase_start_epoch", 20),
        margin_fix_epoch=config.get("margin_fix_epoch", 50),
        scale=config.get("scale", 32.0),
        remat=config.get("remat", False),
        compute_dtype=config.get("compute_dtype", "float32"),
    )


def main(argv=None):
    args, overrides = get_args(argv)
    init_multihost(device=args.device)
    device = resolve_device(args.device)
    set_seed(args.seed)
    config = build_config(args.config, overrides,
                          copy_to_exp_dir=is_main_process())
    os.makedirs(config["exp_dir"], exist_ok=True)
    mesh = train_mesh(config, device)
    dataset, loader, label_encoder = build_loader(config, args.seed,
                                                  mesh=mesh)

    model = build_model(config, args.seed)
    cfg = sv_train_config(config, dataset.num_classes, len(loader))
    fbank = KaldiFbank(FbankConfig(
        sample_rate=config.get("sample_rate", 16000),
        num_mel_bins=config.get("n_mels", 80)), mean_norm=True, device=device)
    train_step = make_sv_train_step(model, cfg, feature_fn=fbank, mesh=mesh)
    state = init_sv_train_state(model, cfg, seed=args.seed, mesh=mesh)
    fit(args, config, device, state, train_step, loader, label_encoder)


def fit(args, config, device: torch.device, state, train_step, loader,
        label_encoder, *, tree_fn=state_tree, warm_start: bool = True,
        log_margin: bool = True) -> None:
    """The epochs of an SV trainer CLI: recover from the experiment's latest
    checkpoint (either trainer's layout), or with ``warm_start`` from
    ``init_exp_dir``; per epoch the train loop, one ``train_epoch.log``
    line, the ``epoch N: ...`` summary and one checkpoint of
    ``tree_fn(state)``; a preemption checkpoint on SIGTERM. Every rank runs
    the loop and builds the trees (they gather the class shards); rank 0
    alone writes."""
    exp_dir = config["exp_dir"]
    step_per_epoch = len(loader)
    epoch_counter = EpochCounter(config.get("num_epoch", 70))
    checkpointer = Checkpointer(os.path.join(exp_dir, "models"),
                                recoverables={"epoch_counter": epoch_counter})
    recovered = checkpointer.recover_if_possible()
    if recovered is not None and "train_state" in recovered:
        load_state_tree(state, recovered["train_state"])
        print(f"recovered from epoch {recovered['__meta__']['epoch']}")
    elif warm_start and config.get("init_exp_dir"):
        # warm start for a large-margin finetune: the weights of another
        # experiment (either trainer's), optimizer and step reset
        src = Checkpointer(os.path.join(config["init_exp_dir"], "models")
                           ).recover_if_possible()
        if src is None or "train_state" not in src:
            raise FileNotFoundError(
                f"--init_exp_dir: no checkpoint under "
                f"{config['init_exp_dir']}/models")
        load_state_tree(state, src["train_state"], optimizer=False)
        print(f"warm start from {config['init_exp_dir']} "
              f"(epoch {src['__meta__']['epoch']}), optimizer reset")

    main_proc = is_main_process()
    n_data = 1 if state.mesh is None else state.mesh.shape["data"]
    logger = EpochLogger(os.path.join(exp_dir, "train_epoch.log"))
    if main_proc:
        label_encoder.save(os.path.join(exp_dir, "label_encoder.pkl"))
    log_every = config.get("log_batch_freq", 50)
    shutdown = GracefulShutdown()
    preempted = False
    tracer = StepTracer(args.profile_dir, num_steps=args.profile_steps)
    global_step = 0
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
            if main_proc and (i + 1) % log_every == 0:
                print(f"epoch {epoch} step {i+1}/{step_per_epoch} "
                      f"loss {float(losses[-1]):.4f} "
                      f"acc {float(accs[-1]):.3f} "
                      f"lr {float(metrics['lr']):.5f}"
                      + (f" margin {float(metrics['margin']):.3f}"
                         if log_margin else ""), flush=True)
        clock.mark()
        timed.close()
        if preempted:
            tree = tree_fn(state)
            if main_proc:
                save_preemption_checkpoint(checkpointer, epoch_counter,
                                           epoch, {"train_state": tree})
            break
        tree = tree_fn(state)
        if not main_proc:
            continue
        logger.log_stats(
            {"epoch": epoch, "time_s": round(time.time() - t0, 1),
             "data_wait_s": round(timed.wait, 1)},
            {"avg_loss": fetch_mean(losses) if losses else None,
             "avg_acc": fetch_mean(accs) if accs else None})
        print_epoch_summary(epoch, clock, timed, loader.batch_size * n_data,
                            time.time() - t0, device)
        checkpointer.save_checkpoint(epoch, {"train_state": tree})
    tracer.close()
    shutdown.finalize(preempted)

if __name__ == "__main__":
    main()
