"""Face detector trainer (``models/face_detector.py::TinyFaceDetector``) on
one CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/train_face_detector.py``: build the
config (YAML + ``--key=value`` overrides, written to
``exp_dir/config.yaml``); per step, a batch of frames and targets built on
the host (rendered faces, ``data/synthetic_faces.py::render_frame``, or
frames of a JSONL of ``{"image": path, "boxes": [[x, y, w, h], ...]}``
named by the config's ``data``, read with cv2), then on the device the
forward, ``detector_loss`` and the JAX step's hand-written Adam
(``train/vad_train.py::make_adam_train_step``: ``g + wd * p`` on every
leaf, BatchNorm scale and bias included; the bias corrections at the fp32
step; 1e-8 outside the square root) at ``warmup_cosine_lr``, in fp32 with
TF32 off. Host batches are built by a background thread ahead of the step
(``data/prefetch.py``). One ``train_epoch.log`` line and one checkpoint in
the JAX trainer's layout (``train_state.ckpt``: the Flax ``params``,
``batch_stats``, ``adam_m``, ``adam_v``, ``step``) per epoch; either
package's ``load_face_detector_exp`` reads it.

Usage:
  python -m speaker3d_tpu_torch.cli.train_face_detector \
      --config configs/face_det.yaml [--device cuda] [--any_yaml_key=value]

Config keys: exp_dir, height, width, batch_size, step_per_epoch,
num_epoch, min_lr, max_lr, warmup_epoch, weight_decay, data, model.args.
Detect with the experiment through ``python -m
speaker3d_tpu_torch.cli.infer_diarization_video --face_detector_exp_dir
<exp_dir>``.

Deliberate differences from the JAX CLI: the initial weights draw from a
torch generator seeded by ``--seed`` with Flax's default distributions
(the JAX PRNG stream cannot be reproduced); the trainer resumes from the
experiment's latest checkpoint (the JAX CLI starts again from its seed);
one card (data-parallel training over several cards is ROADMAP.md M14).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.models.face_detector import (
    STRIDE, TinyFaceDetector, detector_loss, gaussian_heatmap)

MULTI_CARD_NOT_PORTED = ("data-parallel face detector training over "
                         "several cards is ROADMAP.md M14; the trainer runs "
                         "on one card")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Train the tiny face detector")
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the train step; 'cpu' must be "
                        "asked for")
    args, overrides = p.parse_known_args(argv)
    return args, overrides


def make_batch_fn(config):
    """``make_batch(rng) -> {'frames' [B, H, W, 1], 'heat', 'size',
    'mask'}`` (float32 numpy): the JAX CLI's batches, byte-equal for the
    same ``np.random.Generator`` state."""
    height = config.get("height", 144)
    width = config.get("width", 192)
    batch_size = config.get("batch_size", 16)
    real_rows = []
    if config.get("data"):
        with open(config["data"]) as f:
            real_rows = [json.loads(line) for line in f if line.strip()]

    def make_batch(rng):
        frames = np.zeros((batch_size, height, width, 1), np.float32)
        gh, gw = height // STRIDE, width // STRIDE
        heat = np.zeros((batch_size, gh, gw), np.float32)
        size = np.zeros((batch_size, gh, gw, 2), np.float32)
        mask = np.zeros((batch_size, gh, gw), np.float32)
        for i in range(batch_size):
            if real_rows:
                row = real_rows[int(rng.integers(0, len(real_rows)))]
                import cv2

                img = cv2.imread(row["image"], cv2.IMREAD_GRAYSCALE)
                img = cv2.resize(img, (width, height))
                boxes = [tuple(b) for b in row["boxes"]]
            else:
                from speaker3d_tpu_torch.data.synthetic_faces import render_frame

                img, boxes = render_frame(rng, height, width)
            frames[i, :, :, 0] = img.astype(np.float32) / 255.0
            heat[i], size[i], mask[i] = gaussian_heatmap(height, width,
                                                         boxes)
        return {"frames": frames, "heat": heat, "size": size, "mask": mask}

    return make_batch


def detector_batch_loss(outputs, batch):
    heat, sizes = outputs
    loss, _, _ = detector_loss(heat, sizes, batch["heat"], batch["size"],
                               batch["mask"])
    return loss, None


def make_detector_train_step(cfg):
    """``step(state, batch) -> {'loss', 'lr'}``: one Adam step of the JAX
    CLI's on an ``AdamTrainState`` in place (``cfg``: a
    ``train/vad_train.py::VadTrainConfig``)."""
    from speaker3d_tpu_torch.train.vad_train import make_adam_train_step

    return make_adam_train_step(detector_batch_loss, cfg, input_key="frames")


def train_config(config):
    """The config's schedule and weight decay as a ``VadTrainConfig``."""
    from speaker3d_tpu_torch.train.vad_train import VadTrainConfig

    num_epoch = config.get("num_epoch", 15)
    return VadTrainConfig(min_lr=config.get("min_lr", 1e-5),
                          max_lr=config.get("max_lr", 2e-3),
                          warmup_epoch=config.get("warmup_epoch", 1),
                          fix_epoch=num_epoch,
                          step_per_epoch=config.get("step_per_epoch", 20),
                          weight_decay=config.get("weight_decay", 1e-6))


def init_model(config, seed: int) -> TinyFaceDetector:
    """The config's detector with Flax's default initialisation drawn from
    a torch generator seeded with ``seed``."""
    from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_

    model = TinyFaceDetector(**config.get("model", {}).get("args", {}))
    return lecun_init_(model, torch.Generator().manual_seed(seed))


def main(argv=None):
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank_count)
    from speaker3d_tpu_torch.train.vad_train import (
        init_adam_train_state, load_state_tree, state_tree)
    from speaker3d_tpu_torch.utils.checkpoint import (
        Checkpointer, EpochCounter, EpochLogger)
    from speaker3d_tpu_torch.utils.config import build_config
    from speaker3d_tpu_torch.utils.misc import fetch_mean, set_seed

    args, overrides = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if process_rank_count()[1] > 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)
    set_seed(args.seed)
    config = build_config(args.config, overrides, copy_to_exp_dir=True)
    exp_dir = config["exp_dir"]
    os.makedirs(exp_dir, exist_ok=True)

    cfg = train_config(config)
    make_batch = make_batch_fn(config)
    state = init_adam_train_state(init_model(config, args.seed), device)
    train_step = make_detector_train_step(cfg)

    epoch_counter = EpochCounter(cfg.fix_epoch)
    checkpointer = Checkpointer(os.path.join(exp_dir, "models"),
                                recoverables={"epoch_counter": epoch_counter})
    recovered = checkpointer.recover_if_possible()
    if recovered is not None and "train_state" in recovered:
        load_state_tree(state, recovered["train_state"])
        print(f"recovered from epoch {recovered['__meta__']['epoch']}")
    logger = EpochLogger(os.path.join(exp_dir, "train_epoch.log"))
    rng = np.random.default_rng(args.seed)
    batch_size = config.get("batch_size", 16)

    for epoch in epoch_counter:
        t0 = time.time()
        losses = []
        gen = (make_batch(rng) for _ in range(cfg.step_per_epoch))
        timed = _TimedIter(device_prefetch(gen, device))
        clock = _StepClock(device)
        for batch in timed:
            clock.mark()
            losses.append(train_step(state, batch)["loss"])
        clock.mark()
        timed.close()
        avg = fetch_mean(losses)
        logger.log_stats({"epoch": epoch, "time_s": round(time.time() - t0, 1),
                          "data_wait_s": round(timed.wait, 1)},
                         {"avg_loss": avg})
        print(f"epoch {epoch} avg_loss {avg:.4f}", flush=True)
        print_epoch_summary(epoch, clock, timed, batch_size,
                            time.time() - t0, device)
        checkpointer.save_checkpoint(epoch, {"train_state": state_tree(state)})


if __name__ == "__main__":
    main()
