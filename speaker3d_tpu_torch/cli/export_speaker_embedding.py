"""Serialized-model export CLI: torch.export programs and AOTInductor
packages of the feature -> embedding function.

The counterpart of ``speaker3d_tpu/cli/export_speaker_embedding.py``, with
the same flags plus ``--device``: take a registry model id or experiment
dir, export the feature->embedding function with a dynamic batch axis
(input 'feature' [B, T, 80] -> output 'embedding' [B, D]), verify the
exported program against the source model before writing.

The artifact is a ``torch.export`` program (``torch.export.save``, loaded by
``load_exported``); ``--aot_dir`` adds AOTInductor packages of static shape
(``torch._inductor.aoti_compile_and_package``) and ``aot.json`` for the
port's native runtime (``runtime/bin/extract_speaker_embedding.cpp
--engine aot``, libtorch without Python). The ERes2Net models' Res2 blocks
stay on the Res2 kernel in both: their BN folds are computed before the
trace (``models/eres2netv2.py::frozen_folds``) and reach the operator
``s3d::res2_block`` as constants, so the program launches the same kernel
as the eager model. The programs are traced on the card unless ``--device
cpu``; a program runs on the device it was traced on.

Usage:
  python -m speaker3d_tpu_torch.cli.export_speaker_embedding \\
      --model_id ID --local_model_dir pretrained --out model.pt2 \\
      [--aot_dir aot --aot_buckets 1.5,3,6,10] [--frames 300] [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from speaker3d_tpu_torch.eval.embedding import matmul_precision
from speaker3d_tpu_torch.models.eres2netv2 import frozen_folds

MAX_BATCH = 4096                  # the dynamic batch axis' upper bound


def _trace(model, batch, n_frames, feat_dim, precision, dev, dynamic):
    x = torch.zeros((batch, n_frames, feat_dim), device=dev)
    shapes = (({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
              if dynamic else None)
    with frozen_folds(model), matmul_precision(precision, dev):
        return torch.export.export(model, (x,), dynamic_shapes=shapes)


def _embedding_dim(program) -> int:
    (out,) = [n for n in program.graph.nodes if n.op == "output"]
    return int(out.args[0][0].meta["val"].shape[-1])


def export_model(model, *, feat_dim=80, frames=300, try_polymorphic=True,
                 precision="high", device=DEFAULT_DEVICE):
    """Returns (bytes of ``torch.export.save``, meta dict). The batch axis
    is dynamic (traced at batch 2: torch specialises 0 and 1); if that
    trace fails, the program takes batch 1 and ``poly_error`` says why."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    meta = {"feat_dim": feat_dim, "precision": precision,
            "device": dev.type}
    program = None
    if try_polymorphic:
        try:
            program = _trace(model, 2, frames, feat_dim, precision, dev, True)
            meta.update(dynamic_batch=True, frames=frames)
        except Exception as e:  # fall back to a static batch
            meta["poly_error"] = str(e)[:200]
    if program is None:
        program = _trace(model, 1, frames, feat_dim, precision, dev, False)
        meta.update(dynamic_batch=False, frames=frames)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), meta


def _program_device(program) -> torch.device:
    tensors = [t for t in (*program.state_dict.values(),
                           *program.constants.values())
               if isinstance(t, torch.Tensor)]
    return tensors[0].device if tensors else torch.device("cpu")


def load_exported(path):
    """Load an exported program -> callable(feature) on the program's
    device (the input is moved there), with TF32 off (precision "high", as
    ``main`` exports and verifies)."""
    # the ERes2Net programs call s3d::res2_block: register it first
    import speaker3d_tpu_torch.ops.kernels.res2_block_kernel  # noqa: F401

    program = torch.export.load(path)
    dev = _program_device(program)
    module = program.module()

    def call(feature):
        with torch.inference_mode(), matmul_precision("high", dev):
            return module(torch.as_tensor(feature, device=dev))

    return call


def frames_for_samples(samples: int, *, frame_length=400, frame_shift=160):
    """Kaldi snip_edges frame count for a waveform length."""
    return max(1 + (samples - frame_length) // frame_shift, 1)


def export_aot_artifact(model, out_dir, *, feat_dim=80, frames=300, batch=1,
                        precision="high", bucket_seconds=None,
                        sample_rate=16000, device=DEFAULT_DEVICE):
    """Write AOTInductor packages of static shape + ``aot.json`` for the
    native runtime (``runtime/src/aoti_engine.cpp``), which loads them
    through libtorch with no Python.

    ``bucket_seconds``: variable-length serving, one package per duration
    bucket as ``model_f<frames>.pt2``; the native CLI picks the smallest
    bucket >= each chunk and circle-pads, with the 10 s-chunk / 90 s-cap /
    chunk-mean semantics of infer_sv_batch. The LAST bucket is the chunk
    size. Without buckets one ``model.pt2`` of ``frames``. Inductor links
    each package with a host compiler that has OpenMP
    (``runtime/build.py::openmp_cxx``). ``aot.json``
    carries ``precision`` (the native engine sets the same TF32 flags) and
    ``device`` (the packages run only there). Returns the meta dict."""
    from speaker3d_tpu_torch.runtime.build import openmp_cxx

    dev = resolve_device(device)
    model = model.to(dev).eval()
    cxx = openmp_cxx()
    os.makedirs(out_dir, exist_ok=True)

    def export_one(n_frames, stem):
        program = _trace(model, batch, n_frames, feat_dim, precision, dev,
                         False)
        with matmul_precision(precision, dev), \
                torch._inductor.config.patch({"cpp.cxx": (None, cxx)}):
            torch._inductor.aoti_compile_and_package(
                program, package_path=os.path.join(out_dir, stem + ".pt2"))
        return _embedding_dim(program)

    meta = {"feat_dim": feat_dim, "batch": batch,
            "input": "feature [B, T, 80] float32",
            "output": "embedding [B, D] float32",
            "format": "AOTInductor package (torch._inductor."
                      "aoti_compile_and_package)",
            "precision": precision, "device": dev.type}
    if bucket_seconds:
        buckets = []
        for sec in sorted(float(s) for s in bucket_seconds):
            samples = int(sec * sample_rate)
            n_frames = frames_for_samples(samples)
            emb_dim = export_one(n_frames, f"model_f{n_frames}")
            buckets.append({"seconds": sec, "samples": samples,
                            "frames": n_frames})
        meta.update(embedding_dim=emb_dim, buckets=buckets,
                    sample_rate=sample_rate,
                    chunk_seconds=buckets[-1]["seconds"],
                    max_seconds=90.0,
                    # legacy single-shape keys = largest bucket
                    frames=buckets[-1]["frames"])
    else:
        emb_dim = export_one(frames, "model")
        meta.update(embedding_dim=emb_dim, frames=frames)
    with open(os.path.join(out_dir, "aot.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Export speaker embedding model")
    p.add_argument("--exp_dir", default=None)
    p.add_argument("--model_id", default=None)
    p.add_argument("--local_model_dir", default="pretrained")
    p.add_argument("--out", required=True, help="output .pt2 path "
                   "(torch.export.save)")
    p.add_argument("--aot_dir", default=None,
                   help="also write AOTInductor packages + aot.json for the "
                        "native runtime (extract_speaker_embedding "
                        "--engine aot)")
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--feat_dim", type=int, default=80)
    p.add_argument("--aot_buckets", default=None,
                   help="comma-separated durations in seconds (e.g. "
                        "'1.5,3,6,10') for variable-length AOT serving: "
                        "one package per bucket; the native CLI picks "
                        "the smallest bucket per chunk and circle-pads "
                        "(infer_sv_batch chunk/mean semantics). The last "
                        "bucket is the chunk size.")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="trace, verify and compile on this device (cuda "
                        "unless cpu is asked for)")
    return p.parse_args(argv)


def main(argv=None):
    from speaker3d_tpu_torch.cli.extract import load_model

    args = get_args(argv)
    from speaker3d_tpu_torch.parallel.mesh import init_multihost
    init_multihost(device=args.device)  # under torchrun: the process group
    if not (args.exp_dir or args.model_id):
        raise SystemExit("one of --exp_dir / --model_id required")
    dev = resolve_device(args.device)
    model = load_model(args.exp_dir, args.model_id,
                       args.local_model_dir).to(dev).eval()

    blob, meta = export_model(model, feat_dim=args.feat_dim,
                              frames=args.frames, device=dev)

    # verification against the source model before writing (the JAX CLI's
    # check and tolerance)
    run = torch.export.load(io.BytesIO(blob)).module()
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, args.frames, args.feat_dim)).astype(np.float32)).to(dev)
    with torch.inference_mode(), matmul_precision("high", dev):
        got = run(feats).cpu().numpy()
        want = model(feats).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)

    with open(args.out, "wb") as f:
        f.write(blob)
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"exported {len(blob)} bytes -> {args.out} (meta: {meta})")

    if args.aot_dir:
        buckets = ([float(s) for s in args.aot_buckets.split(",")]
                   if args.aot_buckets else None)
        aot_meta = export_aot_artifact(model, args.aot_dir,
                                       feat_dim=args.feat_dim,
                                       frames=args.frames,
                                       bucket_seconds=buckets, device=dev)
        print(f"AOT artifact -> {args.aot_dir} (meta: {aot_meta})")


if __name__ == "__main__":
    main()
