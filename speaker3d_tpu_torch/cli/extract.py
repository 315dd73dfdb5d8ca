"""Embedding extraction CLI on a CUDA card (or the CPU when asked).

The counterpart of ``speaker3d_tpu/cli/extract.py``, with the same flags
plus ``--device`` and ``--local_model_dir``: shard the wav.scp across
processes, extract one embedding per utterance, write an .npz archive or a
Kaldi binary ark + scp.

Two modes:
  - ``chunked`` (default): cap each wav at 90 s, cut it into 10 s chunks
    with the last one circle-padded (to its smallest holding bucket with
    ``--buckets``), batch the chunks of every utterance, average the chunk
    embeddings per utterance.
  - ``exact``: embed each whole utterance alone, at batch 1; an utterance
    shorter than one fbank frame is skipped with a warning.

Usage:
  python -m speaker3d_tpu_torch.cli.extract --model_id ID --data wav.scp \
      --out_dir embeddings [--mode chunked|exact] [--out_type npz|ark] \
      [--local_model_dir pretrained] [--device cuda]
  python -m speaker3d_tpu_torch.cli.extract --exp_dir exp/foo --data wav.scp \
      --out_dir exp/foo/embeddings

``--exp_dir`` takes an experiment of either trainer (``cli/train.py`` of
this package or of the JAX package): its ``config.yaml`` names the model,
its latest checkpoint holds the weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.diar.pipeline import circle_pad
from speaker3d_tpu_torch.ops.fbank import FbankConfig
from speaker3d_tpu_torch.utils.fileio import load_audio
from speaker3d_tpu_torch.utils.wire import wire_quantize

CHUNK_SECONDS = 10.0
MAX_SECONDS = 90.0
# batches issued to the card before the oldest result is read back, so that
# host decode and packing overlap the card's work
IN_FLIGHT = 3


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Extract speaker embeddings")
    p.add_argument("--exp_dir", default=None,
                   help="experiment dir with config + ckpt")
    p.add_argument("--model_id", default=None, help="pretrained model id (registry)")
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--data", required=True, help="wav.scp")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--mode", choices=["chunked", "exact"], default="chunked")
    p.add_argument("--out_type", choices=["npz", "ark"], default="npz",
                   help="'ark' writes a Kaldi binary ark + scp")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--buckets", default=None,
                   help="chunked mode: comma-separated duration buckets in "
                        "seconds (e.g. '1.5,3,6,10'; last = chunk size); the "
                        "final partial chunk circle-pads to its smallest "
                        "holding bucket instead of the full chunk")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--nprocs", type=int, default=1,
                   help="local subprocess fan-out (utils/fanout.py); files "
                        "shard rank::nprocs")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embed call; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def build_model_from_exp(exp_dir: str):
    """(model in eval mode with the latest checkpoint's weights, config) of
    an experiment written by either trainer: the config's ``model.obj``
    maps to this package's class, and the checkpoint's ``train_state``
    holds this package's ``model/...`` tree or the JAX trainer's
    ``params/...`` and ``batch_stats/...``."""
    from speaker3d_tpu_torch.train.sv_train import model_state_dict_from_tree
    from speaker3d_tpu_torch.utils.builder import dynamic_import
    from speaker3d_tpu_torch.utils.checkpoint import Checkpointer
    from speaker3d_tpu_torch.utils.config import build_config

    config = build_config(os.path.join(exp_dir, "config.yaml"))
    model_cls = dynamic_import(config["model"]["obj"])
    model = model_cls(**config["model"].get("args", {}))
    states = Checkpointer(os.path.join(exp_dir, "models")).recover_if_possible()
    if states is None or "train_state" not in states:
        raise FileNotFoundError(f"no checkpoint under {exp_dir}/models")
    model.load_state_dict(model_state_dict_from_tree(
        states["train_state"], like=model.state_dict()), strict=True)
    return model.eval(), config


def load_model(exp_dir, model_id, local_model_dir):
    """The CLIs' model: a trained experiment when ``exp_dir`` is given,
    else the registry id's checkpoint under ``local_model_dir``."""
    if exp_dir:
        return build_model_from_exp(exp_dir)[0]
    from speaker3d_tpu_torch.cli.registry import load_pretrained

    return load_pretrained(model_id, local_model_dir)


def upload_batch(wavs: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch on ``device``; to a card through pinned memory without
    waiting, so the host goes on decoding while the copy and the embed call
    run."""
    t = torch.from_numpy(wavs)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def extract_embeddings(embed_fn, wav_scp, *, mode="chunked", batch_size=64,
                       sample_rate=16000, bucket_seconds=None,
                       device=DEFAULT_DEVICE):
    """Return {utt: emb}. ``embed_fn``: [B, L] -> [B, D] on ``device``
    (``eval.embedding.build_embedding_fn``).

    ``bucket_seconds`` (chunked mode): duration buckets, ascending; the last
    is the chunk size (``eval.chunking.plan_chunks``). Every batch is
    zero-padded to ``batch_size`` rows, so each bucket keeps one shape, and
    PCM16-exact batches ship as int16 (``utils.wire``)."""
    from speaker3d_tpu_torch.eval.chunking import plan_chunks

    dev = resolve_device(device)
    out = {}
    if mode == "exact":
        frame = FbankConfig(sample_rate=sample_rate).frame_length
        for utt, path in wav_scp.items():
            wav = load_audio(path, obj_fs=sample_rate)[0]
            if wav.shape[0] < frame:
                # no fbank frame to embed (the JAX CLI writes NaN here)
                print(f"[WARNING] skipping {utt}: {wav.shape[0]} samples, "
                      f"shorter than one {frame}-sample frame")
                continue
            out[utt] = embed_fn(upload_batch(wav[None], dev))[0].cpu().numpy()
        return out
    if mode != "chunked":
        raise ValueError(f"unknown mode {mode!r}")

    max_len = int(MAX_SECONDS * sample_rate)
    buckets = sorted(int(b * sample_rate)
                     for b in (bucket_seconds or [CHUNK_SECONDS]))
    bufs = {b: [] for b in buckets}  # per padded length
    in_flight = []  # [(utts, embeddings on the device)]

    def drain(limit):
        while len(in_flight) > limit:
            utts, embs = in_flight.pop(0)
            for utt, e in zip(utts, embs[:len(utts)].cpu().numpy()):
                out.setdefault(utt, []).append(e)

    def flush(blen):
        buf = bufs[blen]
        if not buf:
            return
        wavs = np.stack([b[1] for b in buf])
        if len(buf) < batch_size:
            wavs = np.concatenate(
                [wavs, np.zeros((batch_size - len(buf), blen), np.float32)])
        q = wire_quantize(wavs)
        batch = upload_batch(q if q is not None else wavs, dev)
        in_flight.append(([b[0] for b in buf], embed_fn(batch)))
        buf.clear()
        drain(limit=IN_FLIGHT)

    for utt, path in wav_scp.items():
        wav = load_audio(path, obj_fs=sample_rate)[0]
        for c in plan_chunks(wav.shape[0], buckets, max_len):
            piece = wav[c.start:c.start + c.length]
            bufs[c.padded].append((utt, circle_pad(piece, c.padded)))
            if len(bufs[c.padded]) == batch_size:
                flush(c.padded)
    for blen in buckets:
        flush(blen)
    drain(limit=0)
    return {utt: np.mean(np.stack(es), axis=0) for utt, es in out.items()}


def write_embeddings(out_dir: str, embs, out_type: str) -> None:
    """This rank's archive: ``embeddings_<rank>.npz`` or
    ``embedding_<rank>.ark`` + ``.scp``."""
    from speaker3d_tpu_torch.eval.scoring import save_embeddings
    from speaker3d_tpu_torch.parallel.mesh import process_rank
    from speaker3d_tpu_torch.utils.kaldi_ark import write_ark_scp

    os.makedirs(out_dir, exist_ok=True)
    if out_type == "ark":
        base = os.path.join(out_dir, f"embedding_{process_rank()}")
        write_ark_scp(base + ".ark", embs, base + ".scp")
    else:
        save_embeddings(os.path.join(
            out_dir, f"embeddings_{process_rank()}.npz"), embs)


def main(argv=None):
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.parallel.mesh import init_multihost, process_shard
    from speaker3d_tpu_torch.utils.fanout import maybe_fanout
    from speaker3d_tpu_torch.utils.fileio import load_wav_scp

    args = get_args(argv)
    init_multihost(device=args.device)  # under torchrun: the process group
    if not (args.exp_dir or args.model_id):
        raise SystemExit("one of --exp_dir / --model_id is required")
    device = resolve_device(args.device)
    if maybe_fanout("speaker3d_tpu_torch.cli.extract", argv, args.nprocs):
        return
    model = load_model(args.exp_dir, args.model_id, args.local_model_dir)

    wav_scp = load_wav_scp(args.data)
    shard_scp = {k: wav_scp[k] for k in process_shard(sorted(wav_scp))}
    embed_fn = build_embedding_fn(model, device=device, precision="highest",
                                  sample_rate=args.sample_rate)
    buckets = ([float(s) for s in args.buckets.split(",")]
               if args.buckets else None)
    embs = extract_embeddings(embed_fn, shard_scp, mode=args.mode,
                              batch_size=args.batch_size,
                              sample_rate=args.sample_rate,
                              bucket_seconds=buckets, device=device)
    write_embeddings(args.out_dir, embs, args.out_type)
    print(f"wrote {len(embs)} embeddings to {args.out_dir}")


if __name__ == "__main__":
    main()
