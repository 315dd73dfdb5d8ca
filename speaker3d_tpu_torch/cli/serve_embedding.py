"""Speaker-embedding serving daemon CLI on a CUDA card (or the CPU when
asked).

The counterpart of ``speaker3d_tpu/cli/serve_embedding.py``, with the same
flags plus ``--device``: keeps one fbank + backbone embedding function
loaded and micro-batches concurrent requests (``speaker3d_tpu_torch/serve.py``).

Usage:
  python -m speaker3d_tpu_torch.cli.serve_embedding --model_id iic/... \
      --local_model_dir pretrained [--port 7077 | --socket /tmp/emb.sock] \
      [--batch_size 16] [--max_wait_ms 10] [--buckets 1.5,3,6,10] \
      [--device cuda]

Protocol: newline-delimited JSON per connection;
  {"id": "x", "wav": "/path.wav"}                        -> file request
  {"id": "x", "pcm_b64": <b64 float32 mono>, "fs": 16000} -> raw request
  response: {"id": "x", "embedding": [...], "dim": D} | {"id", "error"}
Semantics match infer_sv_batch: 10 s circle-padded chunks, mean embedding,
90 s cap. The server runs on one host and one card. ``--exp_dir`` (a
trained experiment of either trainer) replaces ``--model_id``.
"""

from __future__ import annotations

import argparse

from speaker3d_tpu_torch.device import DEFAULT_DEVICE


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Embedding serving daemon")
    p.add_argument("--exp_dir", default=None,
                   help="a trained experiment instead of --model_id")
    p.add_argument("--model_id", default=None)
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--socket", default=None, help="unix socket path")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (0 = auto) when --socket is not given")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--buckets", default=None,
                   help="comma-separated duration buckets in seconds (e.g. "
                        "'1.5,3,6,10'; last = chunk size): requests micro-"
                        "batch per bucket so short audio doesn't pad to "
                        "the full chunk")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of the embed call; 'cpu' must be "
                        "asked for")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import load_model
    from speaker3d_tpu_torch.device import resolve_device
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.serve import serve

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    if not (args.exp_dir or args.model_id):
        raise SystemExit("one of --exp_dir / --model_id is required")
    device = resolve_device(args.device)
    model = load_model(args.exp_dir, args.model_id, args.local_model_dir)
    embed_fn = build_embedding_fn(model, device=device, precision="high",
                                  sample_rate=args.sample_rate)
    buckets = ([float(s) for s in args.buckets.split(",")]
               if args.buckets else None)
    serve(embed_fn, unix_socket=args.socket, host=args.host, port=args.port,
          batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
          sample_rate=args.sample_rate, bucket_seconds=buckets)


if __name__ == "__main__":
    main()
