"""Self-supervised (RDINO, SDPN) trainer CLI on one CUDA card (or the CPU
when asked).

The counterpart of ``speaker3d_tpu/cli/train_ssl.py`` (reference:
speakerlab/bin/train_rdino.py, bin/train_sdpn.py), with its flags, config
keys, log lines and checkpoints plus ``--device``: build the config (YAML +
``--key=value`` overrides, written to ``exp_dir/config.yaml``), the
multi-crop dataset (``data/dataset_ssl.py``) and its threaded loader, the
ECAPA-TDNN backbone with ``ssl_input_norm`` and the variant's head; recover
from the experiment's latest checkpoint; then per epoch the train loop
(batches through ``data/prefetch.py::device_prefetch``, the mel features
and the step on the card, ``train/ssl_train.py``), one JSON line in
``log.txt`` (the metrics' epoch means and ``time_s``) and one checkpoint
``CKPT-EPOCH-{N}-00/ssl_state.ckpt`` in the JAX trainer's layout, which
both packages' ``extract_ssl`` and trainers read. ``epochs: 0`` saves the
random-init state as ``CKPT-EPOCH-0`` without training (the baseline of
the SSL learning gate). SIGTERM/SIGINT checkpoint the live state at the
next step and exit 0.

Usage:
  python -m speaker3d_tpu_torch.cli.train_ssl --config configs/rdino.yaml \
      [--variant rdino|sdpn] [--device cuda] [--any_yaml_key=value ...]

Config keys: exp_dir, data (wav.scp), noise (wav.scp of MUSAN-style paths
``.../<noise|speech|music>/<a>/<b>/<file>``), rir_bank (.npy [N, L]),
n_mels, max_frames, glb_num, local_num, batch_size, num_workers, epochs,
warmup_epochs, lr (scaled by batch_size / 256), min_lr, weight_decay,
weight_decay_end, momentum_teacher, clip_grad, freeze_last_layer,
embedding_dim, channels, out_dim, add_dim, bottleneck_dim (RDINO),
num_proto, output_dim, memax_weight, koleo_loss_weight (SDPN). As in the
JAX CLI, ``proto_lr`` is not read: the prototypes' lr is
``SSLTrainConfig``'s 0.2, unscaled.

Deliberate differences from the JAX CLI: the initial weights draw from
torch generators seeded by ``--seed`` with the JAX package's distributions
(Flax's ``lecun_normal`` for the backbone, ``truncated_normal(0.02)`` for
the heads, uniform prototypes); the JAX PRNG stream cannot be reproduced.
One card: more than one process raises (data-parallel SSL is ROADMAP.md
M14). Besides the JAX CLI's ``epoch N: {...}`` line it prints the port's
``epoch N: S steps of B, step X ms ...`` summary (CUDA events on the card).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device

MULTI_CARD_NOT_PORTED = ("data-parallel SSL training over several cards is "
                         "ROADMAP.md M14; the trainer runs on one card")


def build_ssl_model(variant: str, config, seed=None) -> torch.nn.Module:
    """The variant's combiner at the config's widths; with ``seed`` its
    initial weights drawn as the module docstring says (the global RNGs
    left as they were)."""
    from speaker3d_tpu_torch.models.ecapa_tdnn import ECAPA_TDNN
    from speaker3d_tpu_torch.models.fsmn_vad import lecun_init_
    from speaker3d_tpu_torch.models.ssl_heads import (
        RDINOCombiner, RDINOHead, SDPNCombiner, SDPNHead)

    gen = torch.Generator()
    gen.manual_seed(0 if seed is None else seed)
    emb = config.get("embedding_dim", 512)
    backbone = ECAPA_TDNN(
        input_size=config.get("n_mels", 80), lin_neurons=emb,
        channels=tuple(config.get("channels", (1024, 1024, 1024, 1024, 3072))),
        ssl_input_norm=True)
    if seed is not None:
        lecun_init_(backbone, gen)
    if variant == "rdino":
        head = RDINOHead(in_dim=emb, out_dim=config.get("out_dim", 65536),
                         add_dim=config.get("add_dim", 8192),
                         bottleneck_dim=config.get("bottleneck_dim", 256),
                         generator=gen)
        return RDINOCombiner(backbone, head)
    head = SDPNHead(in_dim=emb, bottleneck_dim=config.get("output_dim", 256),
                    generator=gen)
    return SDPNCombiner(backbone, head)


def ssl_train_config(config, variant: str, step_per_epoch: int):
    """``SSLTrainConfig`` from the config's keys, as the JAX CLI builds it
    (one card: ``base_lr = lr * batch_size / 256``)."""
    from speaker3d_tpu_torch.train.ssl_train import SSLTrainConfig

    glb_num = config.get("glb_num", 2 if variant == "rdino" else 1)
    local_num = config.get("local_num", 4)
    return SSLTrainConfig(
        base_lr=config.get("lr", 0.2) * config.get("batch_size", 64) / 256.0,
        min_lr=config.get("min_lr", 1e-5),
        epochs=config.get("epochs", 150),
        step_per_epoch=step_per_epoch,
        warmup_epochs=config.get("warmup_epochs", 10),
        weight_decay=config.get("weight_decay", 1e-4),
        weight_decay_end=config.get("weight_decay_end", 1e-4),
        momentum_teacher=config.get("momentum_teacher", 0.996),
        clip_grad=config.get("clip_grad", 3.0),
        freeze_last_layer=config.get("freeze_last_layer", 1),
        ncrops=glb_num + local_num,
        out_dim=config.get("out_dim", 65536),
        num_proto=config.get("num_proto", 1024),
        output_dim=config.get("output_dim", 256),
        num_local_views=local_num,
        memax_weight=config.get("memax_weight", 1.0),
        koleo_weight=config.get("koleo_loss_weight", 0.1),
    )


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Self-supervised training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--variant", choices=["rdino", "sdpn"], default="rdino")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="torch device of the train step; 'cpu' must be "
                             "asked for")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of a window of "
                             "train steps (utils/profiling.py)")
    parser.add_argument("--profile_steps", type=int, default=5)
    return parser.parse_known_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.train import (
        _StepClock, _TimedIter, print_epoch_summary)
    from speaker3d_tpu_torch.data.dataset_ssl import (
        RDINODataset, SDPNDataset, SSLBatchLoader)
    from speaker3d_tpu_torch.data.prefetch import device_prefetch
    from speaker3d_tpu_torch.ops.melspec import MelSpecConfig, MelSpectrogram
    from speaker3d_tpu_torch.parallel.mesh import (
        init_multihost, process_rank_count)
    from speaker3d_tpu_torch.train.ssl_train import (
        init_ssl_state, load_state_tree, make_rdino_train_step,
        make_sdpn_train_step, state_tree)
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.config import build_config
    from speaker3d_tpu_torch.utils.misc import fetch_mean, set_seed
    from speaker3d_tpu_torch.utils.preemption import GracefulShutdown
    from speaker3d_tpu_torch.utils.profiling import StepTracer

    args, overrides = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    device = resolve_device(args.device)
    if process_rank_count()[1] > 1:
        raise NotImplementedError(MULTI_CARD_NOT_PORTED)
    set_seed(args.seed)  # reference: bin/train_rdino.py set_seed
    config = build_config(args.config, overrides, copy_to_exp_dir=True)
    exp_dir = config["exp_dir"]

    glb_num = config.get("glb_num", 2 if args.variant == "rdino" else 1)
    local_num = config.get("local_num", 4)
    ds_cls = RDINODataset if args.variant == "rdino" else SDPNDataset
    dataset = ds_cls(config["data"], noise=config.get("noise"),
                     rir_bank=config.get("rir_bank"),
                     max_frames=config.get("max_frames", 400),
                     glb_num=glb_num, local_num=local_num)
    loader = SSLBatchLoader(dataset, config.get("batch_size", 64),
                            num_workers=config.get("num_workers", 8),
                            seed=args.seed)
    cfg = ssl_train_config(config, args.variant, max(len(loader), 1))

    model = build_ssl_model(args.variant, config, seed=args.seed)
    melspec = MelSpectrogram(MelSpecConfig(n_mels=config.get("n_mels", 80)),
                             device=device)
    state = init_ssl_state(model, cfg, args.variant, device,
                           generator=torch.Generator().manual_seed(
                               args.seed + 7))
    make_step = (make_rdino_train_step if args.variant == "rdino"
                 else make_sdpn_train_step)
    step_fn = make_step(cfg, feature_fn=melspec)

    ckpt = Checkpointer(os.path.join(exp_dir, "models"))
    log_path = os.path.join(exp_dir, "log.txt")
    start_epoch = 0
    recovered = ckpt.recover_if_possible()
    if recovered is not None and "ssl_state" in recovered:
        load_state_tree(state, recovered["ssl_state"])
        start_epoch = int(recovered["__meta__"]["epoch"])
        print(f"recovered from epoch {start_epoch}")
    shutdown = GracefulShutdown()
    preempted = False
    tracer = StepTracer(args.profile_dir, num_steps=args.profile_steps)
    if cfg.epochs == 0 and recovered is None:
        # the random-init teacher as CKPT-EPOCH-0, so that extract_ssl can
        # embed with it (the SSL learning gate's baseline)
        ckpt.save_checkpoint(0, {"ssl_state": state_tree(state)})
    global_step = 0
    for epoch in range(start_epoch, cfg.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        metrics_acc = []
        timed = _TimedIter(device_prefetch(loader, device))
        clock = _StepClock(device)
        for batch in timed:
            clock.mark()
            tracer.before_step(global_step)
            metrics = step_fn(state, batch)
            tracer.after_step(global_step, wait_for=metrics["loss"])
            global_step += 1
            # device scalars, read once per epoch
            metrics_acc.append(metrics)
            if shutdown.poll():
                preempted = True
                break
        clock.mark()
        timed.close()
        if preempted:
            # the last completed epoch's label: recovery redoes this epoch
            d = ckpt.save_checkpoint(epoch, {"ssl_state": state_tree(state)})
            print(f"[preemption] checkpoint saved to {d}; exiting",
                  flush=True)
            break
        if metrics_acc:
            avg = {k: fetch_mean([m[k] for m in metrics_acc])
                   for k in metrics_acc[0]}
            wall = time.time() - t0
            with open(log_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, **avg,
                                    "time_s": round(wall, 1)}) + "\n")
            ckpt.save_checkpoint(epoch + 1, {"ssl_state": state_tree(state)})
            print(f"epoch {epoch+1}: {avg}")
            print_epoch_summary(epoch + 1, clock, timed, loader.batch_size,
                                wall, device)
    tracer.close()
    shutdown.finalize(preempted)


if __name__ == "__main__":
    main()
