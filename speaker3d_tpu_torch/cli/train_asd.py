"""TalkNet active-speaker-detection trainer on one CUDA card (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/train_asd.py``, with its flags,
defaults and printed lines, plus ``--device``: the AVA layout's
length-sorted mini-batches (``data/dataset_asd.py``; ``--batch_size`` in
frames), shuffled per epoch by ``np.random.default_rng(epoch)``, each
assembled on a background thread and copied to the card ahead of the step
(``data/prefetch.py``); the step of ``train/asd_train.py`` (``CE(AV) + 0.4
CE(A) + 0.4 CE(V)``, Adam at ``lr * lr_decay ** epoch``, fp32 with TF32
off); after each epoch the mAP of the first 200 validation clips
(``evaluate``: batch 1, eval mode), the JAX CLI's ``epoch N: loss ... val
mAP ...`` line, the port trainers' ``epoch N: S steps of F, step ...`` line
(F the mean frames a step, samples/s in frames: step times, data wait,
peak memory), and a checkpoint ``CKPT-EPOCH-<N>`` in the JAX trainer's layout
(``asd_state``: the Flax ``params``, ``batch_stats``, ``mu``, ``nu``,
``step``). ``--test`` reads the latest checkpoint of either package's
trainer and prints ``mAP: xx.xx%`` over every validation clip. As in the
JAX CLI, training resumes nothing, and the first batch is drawn once before
training (the JAX CLI's init draw), so the augmentation draws follow the
JAX CLI's.

Usage:
  python -m speaker3d_tpu_torch.cli.train_asd --train_csv train.csv \\
      --val_csv val.csv --audio_dir ... --video_dir ... --exp_dir exp/asd \\
      [--device cuda] [--test]

Deliberate difference from the JAX CLI: the initial weights draw from a
torch generator seeded by ``--seed`` with Flax's distributions
(``train/asd_train.py::init_talknet``); the JAX CLI draws from
``PRNGKey(0)``, whose stream cannot be reproduced.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def evaluate(model, val_data, device, limit=None) -> float:
    """Average precision of ``softmax(AV)[..., 1]`` over the frames of the
    first ``limit`` validation clips (all by default), each at batch 1 in
    eval mode."""
    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.utils.metrics import average_precision

    was_training = model.training
    model.eval()
    scores, labels = [], []
    n = len(val_data) if limit is None else min(limit, len(val_data))
    with torch.inference_mode(), matmul_precision("float32", device):
        for i in range(n):
            a, v, y = val_data[i]
            av, _, _ = model(
                torch.from_numpy(a.astype(np.float32)).to(device),
                torch.from_numpy(v.astype(np.float32)).to(device))
            s = torch.softmax(av, dim=-1)[..., 1]
            scores.append(s.cpu().numpy().reshape(-1))
            labels.append(np.asarray(y).reshape(-1))
    model.train(was_training)
    return average_precision(np.concatenate(labels), np.concatenate(scores))


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_csv", required=True)
    p.add_argument("--val_csv", required=True)
    p.add_argument("--audio_dir", required=True)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--batch_size", type=int, default=500,
                   help="frames per mini-batch (length-sorted batching)")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=0.95)
    p.add_argument("--test", action="store_true")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of a window of "
                        "train steps (utils/profiling.py)")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the train step and the evaluation; "
                        "'cpu' must be asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.dataset_asd import TrainData, ValData
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.models.talknet import talknet_from_flax
    from speaker3d_tpu_torch.train.asd_train import (
        ASDTrainConfig, init_talknet, make_asd_train_step, state_tree)
    from speaker3d_tpu_torch.train.vad_train import init_adam_train_state
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.misc import fetch_mean, set_seed
    from speaker3d_tpu_torch.utils.preemption import GracefulShutdown
    from speaker3d_tpu_torch.utils.profiling import StepTracer

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    set_seed(args.seed)  # reference: bin/train_asd.py seeds the RNGs
    os.makedirs(args.exp_dir, exist_ok=True)

    val_data = ValData(args.val_csv, args.audio_dir, args.video_dir)
    ckpt = Checkpointer(os.path.join(args.exp_dir, "models"))

    if args.test:
        states = ckpt.recover_if_possible()
        model = talknet_from_flax(
            {"params": states["asd_state"]["params"],
             "batch_stats": states["asd_state"]["batch_stats"]}).to(device)
        m_ap = evaluate(model, val_data, device)
        print(f"mAP: {100 * m_ap:.2f}%")
        return

    train_data = TrainData(args.train_csv, args.audio_dir, args.video_dir,
                           args.batch_size)
    cfg = ASDTrainConfig(lr=args.lr, lr_decay=args.lr_decay,
                         step_per_epoch=max(len(train_data), 1))
    train_data[0]  # the JAX CLI's init draw: it consumes augmentation draws
    state = init_adam_train_state(init_talknet(args.seed), device)
    step = make_asd_train_step(cfg)

    shutdown = GracefulShutdown()
    preempted = False
    tracer = StepTracer(args.profile_dir, num_steps=args.profile_steps)
    global_step = 0
    order = np.arange(len(train_data))

    def host_batches():
        for bi in order:
            a, v, y = train_data[int(bi)]
            yield {"audio": a.astype(np.float32),
                   "visual": v.astype(np.float32),
                   "labels": y.astype(np.int32)}

    for epoch in range(args.epochs):
        np.random.default_rng(epoch).shuffle(order)
        t0, losses, frames = time.time(), [], 0
        timed = _TimedIter(device_prefetch(host_batches(), device))
        clock = _StepClock(device)
        for batch in timed:
            clock.mark()
            tracer.before_step(global_step)
            metrics = step(state, batch)
            tracer.after_step(global_step, wait_for=metrics["loss"])
            global_step += 1
            frames += batch["labels"].numel()
            losses.append(metrics["loss"])  # a device scalar: no sync here
            if shutdown.poll():
                preempted = True
                break
        clock.mark()
        timed.close()
        if preempted:
            d = ckpt.save_checkpoint(epoch, {"asd_state": state_tree(state)})
            print(f"[preemption] checkpoint saved to {d}; exiting", flush=True)
            break
        m_ap = evaluate(state.model, val_data, device, limit=200)
        avg_loss = fetch_mean(losses) if losses else float("nan")
        print(f"epoch {epoch+1}: loss {avg_loss:.4f} "
              f"val mAP {100*m_ap:.2f}% ({time.time()-t0:.0f}s)", flush=True)
        # a sample is a frame: the mean frames a step
        print_epoch_summary(epoch + 1, clock, timed,
                            round(frames / max(len(losses), 1)),
                            time.time() - t0, device)
        ckpt.save_checkpoint(epoch + 1, {"asd_state": state_tree(state)})
    tracer.close()
    shutdown.finalize(preempted)


if __name__ == "__main__":
    main()
