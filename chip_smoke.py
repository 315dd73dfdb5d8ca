#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's diarization (every clustering type),
speaker-verification, serving and analysis paths, every registry backbone
and the recipe backbones, on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. Imports no JAX. Phases, any failure exits non-zero:

1. the card's name and power limit, the torch and CUDA versions;
2. build every CUDA kernel from ``speaker3d_tpu_torch/csrc`` (one nvcc each,
   in parallel);
3. the port's diarization CLI on a seeded synthetic 120 s three-speaker
   conversation, once with the default ERes2NetV2 w24s4ep4 and once with the
   17.8M ERes2NetV2, both on seeded random weights saved as reference-named
   checkpoints; launch counts (K1 in both runs, K2 7x per embed batch in the
   17.8M run and never in the other) and the pad length L of every embed
   call; then, at every L of those calls and at 24,000 (1.5 s), one batch
   of 64 windows embedded through the kernels against the plain functions
   on the card (cosine >= 0.9999);
4. the port's speaker-verification CLIs on a seeded synthetic wav.scp of
   nine utterances from 0.02 s (shorter than a frame) to 95 s (past the
   90 s cap), with the 17.8M model: ``extract`` chunked to a Kaldi ark,
   chunked with duration buckets to npz, and exact; ``infer_sv`` on one
   pair; ``infer_sv_batch`` on a wav list that names one missing file;
   ``extract`` chunked on a seeded 12,800 s corpus (20 full [64, 160000]
   batches, the throughput run); ``compute_score_metrics`` on a trial list
   over the ark. Launch counts per run (K1 > 0, or the exact number of
   embed calls, and K2 7x K1), every output finite; against the plain
   functions on the card at cosine >= 0.9999: the chunked and bucketed
   embeddings (each utterance's plan embedded chunk by chunk), the exact
   and ``infer_sv`` ones (each whole utterance at batch 1), and one
   [64, 160000] batch; ``infer_sv_batch`` against the chunked ``extract``
   run, each printed score against the host's float64 cosine to 1e-5; the
   corpus run's throughput in audio-seconds per second;
5. the registry's other backbones at registry width on seeded
   reference-named checkpoints: CAM++ (192 and 512), ERes2Net base, large
   and huge, ECAPA-TDNN (1024 x 4, 3072); each through ``extract`` on the
   SV utterances (launches: K2 7x K1 for base and large, 0 otherwise),
   held against each utterance's plan through the plain functions, and one
   [64, 160000] batch through the kernels against the plain functions
   (cosine >= 0.9999, both timed); then ResNet34, Res2Net and x-vector at
   their recipe widths (configs/resnet.yaml, res2net.yaml, xvector.yaml, 80
   mel bins; no registry id, so no CLI): the same batch through the embed
   call (K1 once, K2 never) against the plain functions, timed, with its
   FLOP count and parameter count;
6. the embedding server: ``serve()`` in a thread on TCP port 0 with the
   17.8M model, eight client threads sending 40 seeded requests (39 of
   0.5-30 s and one of 95 s) as wav paths and as pcm_b64; launches (K2 7x K1), every
   embedding against its plan through the plain functions (cosine >=
   0.9999), request latency p50/p99 and requests/s; then
   ``python -m speaker3d_tpu_torch.cli.serve_embedding --port 0`` as a
   process answering one request, terminated after it;
7. K1 (fbank) on [64, L] for each of those L and 160,000, and on [1,
   1520000] (the 95 s utterance at batch 1), against its plain version on
   the card, with the Kaldi-oracle thresholds of the CPU tests, and at the
   other windows and mel widths it takes (8 kHz [64, 80000], 48 kHz [64,
   480000], M = 64); kernel and plain times, the bound at the 3xTF32
   tensor-core rate (the fp32 CUDA-core bound, the share of the bound
   reached and the share of the card's measured mma.sync TF32 rate beside
   it);
8. K2 (Res2 block) at the four block shapes of the 17.8M model's layer1-2
   at each of those L (B = 64) and at the 95 s utterance (B = 1, 9,498
   frames), and of ERes2Net base and large at the 10 s chunk (B = 64),
   against its plain version, fp32 with TF32 off, rtol = atol = 1e-3 and
   max abs error <= 1e-4; times, the bound at the 3xTF32 tensor-core rate
   (the fp32 CUDA-core bound beside it) and the share of the bound reached;
9. K3 (the five layout probes): the probe tool's own run on the card, one
   fused launch of all five, each output held against its plain version
   (a-c bit-exact, d and e within 2^-8 max|want| and unequal in at most 1%
   of elements), the launch timed; the launch floor (an empty kernel
   through the same ctypes path); then each probe's own launch, plain and
   library times;
10. the device NN-chain AHC on 5,000 well-separated embeddings against the
    host float64 NN-chain partition;
11. the diarization CLI with the 17.8M model on the 120 s conversation,
    once per clustering type (spectral on the card, spectral on the host,
    UMAP+HDBSCAN with its layout on the card; the file listed twice, so
    the second call's ``cluster`` stage is warm; the oracle count of 3 and
    the centroid merge off, as random weights would merge every speaker):
    launches (K2 7x K1), an
    RTTM each, speakers and stage times; ``compute_der`` of each RTTM
    against itself (DER 0) and of the two spectral RTTMs against each
    other;
12. ``check_single_speaker`` on the SV utterances of 3 s and longer and
    ``analyze_similarity`` over the bucketed extract run's embeddings, on
    the card: launches, and every cosine against the host's float64
    ``cosine_affinity`` of the same embeddings to 1e-5;
13. spectral clustering's device path against its host path on seeded
    embeddings of 12 speakers (d = 192, spread 0.05) at N = 1,024 (dense
    eigh) and 5,000 (LOBPCG): the same partition, both timed; UMAP+HDBSCAN
    (native, the layout on the card) at N = 2,000: the 12 speakers with at
    most 1% noise, the layout and HDBSCAN timed.

The kernels line gives K1's and K2's times at the L of the diarization
file's chunk calls (the path's most frequent batch), every other shape in
``shapes`` (K2's per-batch sums in ``per_batch``), and their launches in the
diarization, SV, backbone, server, clustering-CLI and analysis runs
together (``launches_by_path`` apart).

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Times come from CUDA events around many back-to-back calls
(median of a few such runs, after warm-up) on the card named in the output.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FS = 16000
BATCH = 64
CHUNK = 24000                     # 1.5 s at 16 kHz
PEAK_FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_TC_FLOPS = 989e12       # H100 SXM, bf16 on the tensor cores, dense
PEAK_TF32_TC_FLOPS = 495e12       # H100 SXM, TF32 on the tensor cores, dense
TF32_PASSES = 3                   # K1's and K2's fp32-accurate products: 3xTF32
K2_MAX_ABS_ERR = 1e-4             # fp32 level (one TF32 pass: ~4e-3)
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
MODEL_W24 = "iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common"
MODEL_17M = "iic/speech_eres2netv2_sv_zh-cn_16k-common"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20, runs: int = 5) -> float:
    """Milliseconds per call of ``fn``: the port's timer (``iters`` calls
    between one pair of CUDA events, median of ``runs``)."""
    from speaker3d_tpu_torch.device import cuda_ms as timer

    return timer(fn, warmup, iters, runs)


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fbank_oracle_check(got, want, what: str) -> float:
    """The Kaldi-oracle thresholds of tests/test_fbank_ref_oracle.py: bins
    within 8 nats of the frame's peak to 5e-4, all bins to 2e-2, mean 1e-3."""
    diff = np.abs(got - want)
    strong = want > want.max(axis=-1, keepdims=True) - 8.0
    ok = (diff[strong].max() < 5e-4 and diff.max() < 2e-2
          and diff.mean() < 1e-3)
    if not ok:
        raise AssertionError(f"{what}: strong {diff[strong].max():.3g}, all "
                             f"{diff.max():.3g}, mean {diff.mean():.3g}")
    return float(diff.max())


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi}


def phase_build():
    from speaker3d_tpu_torch.kernels import build

    t0 = time.perf_counter()
    took = build.build(verbose=True)
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in took.items()})} "
        f"total {time.perf_counter() - t0:.2f} s")


def _test_waves(rng, batch: int, n: int, fs: int = FS):
    t = np.arange(n) / fs
    f0 = rng.uniform(100, 400, size=(batch, 1))
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3.1 * f0 * t + 0.5)
    wav += 0.02 * rng.standard_normal((batch, n))
    return wav.astype(np.float32)


def _at(rows: list, main_len: int) -> list:
    return [r for r in rows if r["L"] == main_len]


def mma_sync_tf32_tflops() -> float:
    """The card's mma.sync.m16n8k8 TF32 rate (the instruction of K1 and K2):
    the probe library's register-only loop, 16 warps on every SM."""
    import torch

    from speaker3d_tpu_torch.tools import probe_ops as po

    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 512, 4096
    out = torch.empty(blocks * threads, device="cuda")
    n_mma = po.mma_rate_launch(out, blocks, threads, iters)
    ms = cuda_ms(lambda: po.mma_rate_launch(out, blocks, threads, iters),
                 warmup=1, iters=3, runs=3)
    return n_mma * 2 * 16 * 8 * 8 / ms / 1e9


# K1 at the windows and mel widths it takes besides the path's 16 kHz / 80
# mel bins: (sample rate, mel bins, L) — the 10 s chunk at 8 and 48 kHz, and
# M = 64, whose 8 mel n-tiles are not a multiple of the kernel's MEL_NG = 5
K1_OTHER = ((8000, 80, 80000), (48000, 80, 480000), (FS, 64, 10 * FS))


def phase_k1(lengths, main_len: int) -> dict:
    import torch

    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk

    rate = mma_sync_tf32_tflops()
    log(f"[K1 ceiling] mma.sync TF32 on this card {rate:.1f} TFLOP/s "
        f"({rate / (PEAK_TF32_TC_FLOPS / 1e12):.1%} of the dense TF32 peak)")
    rng = np.random.default_rng(0)
    rows = []
    for fs, mels, L, batch in ([(FS, 80, L, BATCH) for L in lengths]
                               + [(FS, 80, SV_LONGEST, 1)]
                               + [(*c, BATCH) for c in K1_OTHER]):
        cfg = FbankConfig(sample_rate=fs, num_mel_bins=mels)
        fb = KaldiFbank(cfg, device="cuda")
        kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
        wav = torch.from_numpy(_test_waves(rng, batch, L, fs)).cuda()
        with torch.inference_mode(), matmul_precision("float32"):
            got = fk.fbank_cuda(wav, fb._packed, **kw)
            want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
            torch.cuda.synchronize()
            err = fbank_oracle_check(got.cpu().numpy(), want.cpu().numpy(),
                                     f"K1 vs plain at {fs} Hz, M = {mels}, "
                                     f"[{batch}, {L}]")
            ms = cuda_ms(lambda: fk.fbank_cuda(wav, fb._packed, **kw))
            plain = cuda_ms(lambda: fk.fbank_plain(wav, fb._B, fb._mel, **kw))
        T, M = got.shape[1], got.shape[2]
        # the function's inputs (waveform, B, mel) read once, out written once
        n_bytes = 4 * (wav.numel() + fb._B.numel() + fb._mel.numel()
                       + got.numel())
        nb = fb._packed.n_bins
        flops = 2 * batch * T * (cfg.frame_length * 2 * nb + nb * M)
        # the route's rate: each fp32 product is TF32_PASSES TF32 products
        b, by = bound_ms(n_bytes, TF32_PASSES * flops, PEAK_TF32_TC_FLOPS)
        b32, _ = bound_ms(n_bytes, flops, PEAK_FP32_FLOPS)
        log(f"[K1 {fs} Hz M={M} B={batch} L={L}] out {tuple(got.shape)} "
            f"max_abs_err {err:.3g} kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.4f} ms ({by}; "
            f"3xTF32) fp32-core bound {b32:.4f} ms; {b / ms:.1%} of the bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s; "
            f"{TF32_PASSES * flops / ms / 1e9 / rate:.1%} of the mma.sync rate")
        rows.append({"rate": fs, "mels": M, "B": batch, "L": L,
                     "out": list(got.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by})
        del wav, got, want
    (top,) = [r for r in _at(rows, main_len) if r["rate"] == FS
              and r["mels"] == 80]
    return {"name": "fbank", "route": "cuda",
            "source": "speaker3d_tpu_torch/csrc/fbank.cu",
            "replaces": "speaker3d_tpu/ops/pallas/fbank_kernel.py:38",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per launch on the [64, main_len] batch; every L in shapes
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shapes": rows}


# the scale-2 block geometries K2 takes, (m_channels, base_width): the
# 17.8M ERes2NetV2 (the diarization and SV paths) and ERes2Net base / VOX
# and large (the backbones phase; large's layer2, w = 64 with Cout = 256,
# takes the 8 x 16 tile)
K2_MODELS = {"17.8M": (64, 26), "eres2net_base": (32, 32),
             "eres2net_large": (64, 32)}


def k2_shapes(frames: int, m: int = 64) -> list:
    """(name, Cin, planes, stride, input F, input T, blocks of this shape) of
    layer1-2 (3 + 4 blocks) of a model with ``m_channels`` m, expansion 2,
    at ``frames`` fbank frames: 7 blocks per batch."""
    half = (frames - 1) // 2 + 1  # after layer2.0's stride 2
    return [("layer1.0", m, m, 1, 80, frames, 1),
            ("layer1.1", 2 * m, m, 1, 80, frames, 2),
            ("layer2.0", 2 * m, 2 * m, 2, 80, frames, 1),
            ("layer2.1", 4 * m, 2 * m, 1, 40, half, 3)]


def _random_block(cin, planes, stride, gen, base_width=26):
    import torch

    from speaker3d_tpu_torch.models.eres2netv2 import BasicBlockERes2NetV2

    blk = BasicBlockERes2NetV2(cin, planes, stride=stride,
                               base_width=base_width)
    with torch.no_grad():
        for name, t in blk.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var") or name.endswith(".weight") and t.ndim == 1:
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean") or name.endswith(".bias"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            else:  # conv weights, He-scaled
                fan_in = t[0].numel()
                t.copy_(torch.randn(t.shape, generator=gen) * (2 / fan_in) ** 0.5)
    return blk.cuda().eval()


def phase_k2(lengths, main_len: int) -> dict:
    import torch

    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk

    cfg = FbankConfig()
    frames = lambda L: 1 + (L - cfg.frame_length) // cfg.frame_shift
    # the 17.8M model at every L of the path and at the 95 s utterance (B =
    # 1); ERes2Net base and large at the SV chunk
    runs = ([("17.8M", L, BATCH) for L in lengths] + [("17.8M", SV_LONGEST, 1)]
            + [(m, SV_CHUNK, BATCH) for m in ("eres2net_base", "eres2net_large")])
    cases = [(model, L, batch, *shape) for model, L, batch in runs
             for shape in k2_shapes(frames(L), K2_MODELS[model][0])]
    gen = torch.Generator().manual_seed(1)
    gen_x = torch.Generator(device="cuda").manual_seed(1)
    rows, fp32_core = [], {}  # fp32-core bound per batch at each L: logged only
    for model, L, batch, name, cin, planes, stride, f, t, count in cases:
        blk = _random_block(cin, planes, stride, gen, K2_MODELS[model][1])
        p = blk.folded()
        x = torch.rand((batch, cin, f, t), generator=gen_x, device="cuda")
        with torch.inference_mode(), matmul_precision("float32"):
            got = rk.res2_block_cuda(x, p, stride)
            want = rk.res2_block_plain(x, p, stride)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
            if err > K2_MAX_ABS_ERR:
                raise AssertionError(f"K2 {model} {name} at [{batch}, {L}]: "
                                     f"max abs error {err:.3g} > "
                                     f"{K2_MAX_ABS_ERR}")
            ms = cuda_ms(lambda: rk.res2_block_cuda(x, p, stride), iters=5, runs=3)
            plain = cuda_ms(lambda: rk.res2_block_plain(x, p, stride), iters=5, runs=3)
        w, cout = p.width, got.shape[1]
        pos = got.shape[0] * got.shape[2] * got.shape[3]
        flops = 2 * pos * (cin * 2 * w + 2 * 9 * w * w + 2 * w * cout
                           + (cin * cout if p.wsc is not None else 0))
        n_weights = sum(v.numel() for v in (p.w1, p.b1, p.wc1, p.bc1,
                                            p.wc2, p.bc2, p.w3, p.b3))
        n_weights += p.wsc.numel() if p.wsc is not None else 0
        # stride 2 needs only the even rows and columns of x
        n_in = x.numel() // (stride * stride)
        n_bytes = 4 * (n_in + got.numel() + n_weights)
        # the route's rate: each fp32 product is TF32_PASSES TF32 products
        b, by = bound_ms(n_bytes, TF32_PASSES * flops, PEAK_TF32_TC_FLOPS)
        b32, _ = bound_ms(n_bytes, flops, PEAK_FP32_FLOPS)
        log(f"[K2 {model} B={batch} L={L} {name}] x {tuple(x.shape)} w {w} -> "
            f"{tuple(got.shape)} "
            f"max_abs_err {err:.3g} kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"bound {b:.4f} ms ({by}; 3xTF32) fp32-core bound {b32:.4f} ms; "
            f"{b / ms:.1%} of the bound, {flops / ms / 1e9:.1f} TFLOP/s")
        rows.append({"model": model, "B": batch, "L": L, "shape": name,
                     "x": list(x.shape), "w": w, "blocks": count,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by})
        key = (model, L, batch)
        fp32_core[key] = fp32_core.get(key, 0.0) + count * b32
        del x, got, want
    per_batch = {}
    for model, L, batch in runs:
        sel = [r for r in rows if (r["model"], r["L"], r["B"]) == (model, L, batch)]
        per_batch[(model, L, batch)] = pb = {
            k: sum(r["blocks"] * r[k] for r in sel)
            for k in ("ms", "plain_ms", "bound_ms")}
        log(f"[K2 {model} per [{batch}, {L}] batch, 7 launches] kernel "
            f"{pb['ms']:.3f} ms plain {pb['plain_ms']:.3f} ms bound "
            f"{pb['bound_ms']:.3f} ms (3xTF32) fp32-core bound "
            f"{fp32_core[(model, L, batch)]:.3f} ms; "
            f"{pb['bound_ms'] / pb['ms']:.1%} of the bound")
    top = [r for r in rows if r["model"] == "17.8M" and r["L"] == main_len]
    return {"name": "res2_block", "route": "cuda",
            "source": "speaker3d_tpu_torch/csrc/res2_block.cu",
            "replaces": "speaker3d_tpu/ops/pallas/res2_block_kernel.py:143",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per [64, main_len] embed batch of the 17.8M model: the 7
            # launches of layer1-2
            **per_batch[("17.8M", main_len, BATCH)],
            "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                             for r in top) else "bytes"),
            "library_ms": None,
            "per_batch": [{"model": m, "L": L, "B": b, **v}
                          for (m, L, b), v in per_batch.items()],
            "shapes": rows}


def _device_ms(fn, kernel: str, calls: int = 20) -> str:
    """The device time per launch of the kernel named ``kernel`` over
    ``calls`` calls of ``fn``, from torch.profiler's CUDA activity; "not
    measured" when the trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0)
        if kernel in ev.key and ev.count and total:
            return f"{total / ev.count / 1e3:.4f} ms ({ev.count} launches traced)"
    return "not measured (no device time in the trace)"


def phase_k3() -> dict:
    import torch.nn.functional as nnf

    from speaker3d_tpu_torch.tools import probe_ops as po

    # the probe tool's own path: one fused launch of all five probes, each
    # output held against its plain version, the launch timed; the count
    # set to 0 just before, read just after
    po.probe_all.launches = 0
    run = po.ToolRun()
    if po.main([], run) != 0:
        failed = run.error or [r.error for r in run.results if r.error]
        raise AssertionError(f"K3: the probe tool failed: {failed}")
    launches = po.probe_all.launches
    if launches < 1:
        raise AssertionError("K3: the fused probe launch never ran")
    floor_ms = cuda_ms(po.empty_launch)
    log(f"[K3 launch floor] empty kernel through the ctypes path "
        f"{floor_ms:.4f} ms a launch")

    by_key = {r.probe.key: r for r in run.results}
    x, w9 = by_key["d"].args
    w2 = by_key["e"].args[1]
    f, t, w = x.shape
    log(f"[K3 fused] device time of one launch (profiler): "
        f"{_device_ms(lambda: po.probe_all(x, w9, w2), 'probe_all_kernel')}")
    # one PyTorch call per probe that computes the same function
    x_nchw = x.permute(2, 0, 1).unsqueeze(0)                  # [1, W, F, T]
    conv_w = w9.view(3, 3, w, w).permute(3, 2, 0, 1).contiguous()
    library = {"a": lambda: x[:, 1:-1] * 2,
               "b": lambda: nnf.pad(x[:, :-2], (0, 0, 2, 0)),
               "c": lambda: x * 2,
               "d": lambda: nnf.conv2d(x_nchw, conv_w, padding=(1, 0)),
               "e": None}
    # bytes each function must move (inputs read once, outputs written
    # once; a reads only rows 1..T-2, b only rows 0..T-3) and its operations
    elt = 2  # bf16
    n_x, n_mid = f * t * w, f * (t - 2) * w
    work = {"a": (elt * 2 * n_mid, n_mid, PEAK_FP32_FLOPS),
            "b": (elt * (n_mid + n_x), 0, PEAK_FP32_FLOPS),
            "c": (elt * 2 * n_x, n_x, PEAK_FP32_FLOPS),
            "d": (elt * (n_x + w9.numel() + n_mid), 2 * n_mid * 9 * w,
                  PEAK_BF16_TC_FLOPS),
            "e": (elt * (2 * n_x + w2.numel()),
                  2 * n_x * 2 * w + n_x, PEAK_BF16_TC_FLOPS)}
    rows = []
    for key, r in by_key.items():
        # the per-probe entry's own launch (not the tool's path)
        ms = cuda_ms(lambda: r.probe.run(*r.args))
        device = _device_ms(lambda: r.probe.run(*r.args), f"probe_{key}_kernel")
        plain_ms = cuda_ms(lambda: r.probe.plain(*r.args))
        lib_ms = cuda_ms(library[key]) if library[key] else None
        b, by = bound_ms(*work[key])
        log(f"[K3 {key}] {r.probe.name}: out {tuple(r.got.shape)} max_abs_err "
            f"{r.max_abs_err:.3g} own launch {ms:.4f} ms (device {device}) "
            f"plain {plain_ms:.4f} "
            f"ms library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
            f"bound {b:.6f} ms ({by})")
        rows.append({"name": key, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b, "bound_by": by,
                     "max_abs_err": r.max_abs_err})
    bound = sum(r["bound_ms"] for r in rows)
    log(f"[K3 fused] one launch of all five probes {run.ms:.4f} ms (launch "
        f"floor {floor_ms:.4f} ms), plain versions together "
        f"{sum(r['plain_ms'] for r in rows):.4f} ms, bound {bound:.6f} ms; "
        f"launches in the tool's run {launches}")
    return {"name": "probe_ops", "route": "cuda",
            "source": "speaker3d_tpu_torch/csrc/probe_ops.cu",
            "replaces": "tools/probe_mosaic_ops.py:27",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # the tool's fused launch against the five plain versions
            "ms": run.ms,
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations"),
            # no one call computes all five (each row has its own)
            "library_ms": None, "shapes": rows}


def synth_conversation(seconds: float = 120.0, seed: int = 0) -> np.ndarray:
    """Three harmonic 'speakers' (distinct pitch and timbre) taking turns of
    2-6 s with 0.3-1.0 s pauses, seeded; PCM16-exact float32."""
    rng = np.random.default_rng(seed)
    voices = [(130.0, [1.0, 0.6, 0.3, 0.2]), (210.0, [1.0, 0.2, 0.5, 0.1]),
              (320.0, [1.0, 0.4, 0.1, 0.3])]
    out, n_total = [], int(seconds * FS)
    n, spk = 0, 0
    while n < n_total:
        pause = np.zeros(int(rng.uniform(0.3, 1.0) * FS), np.float32)
        dur = int(rng.uniform(2.0, 6.0) * FS)
        t = np.arange(dur) / FS
        f0, amps = voices[spk]
        f = f0 * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        phase = 2 * np.pi * np.cumsum(f) / FS
        sig = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
        env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.05)
        seg = 0.25 * sig * env + 0.003 * rng.standard_normal(dur)
        out += [pause, seg.astype(np.float32)]
        n += len(pause) + dur
        spk = (spk + int(rng.integers(1, 3))) % 3
    wav = np.concatenate(out)[:n_total]
    return (np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768).astype(
        np.float32)


def _random_bn_stats(model, seed: int):
    """Seeded BatchNorm statistics that keep a random trunk's activations
    alive: variances U(0.5, 1.5), means 0.1 N(0, 1)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return model


def _save_checkpoint(model_id: str, root: str, seed: int) -> None:
    import torch

    from speaker3d_tpu_torch.cli.registry import SUPPORTS, build_model

    model = _random_bn_stats(build_model(model_id), seed)
    path = os.path.join(root, model_id, SUPPORTS[model_id]["model_pt"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path)


def _plain_embed(model, fb, wav):
    """The embed call with the plain functions instead of the kernels: K1's
    plain fbank, and every block that the model sends to K2 through
    ``res2_block_plain`` (the blocks' module-level ``res2_block`` swapped
    for the call)."""
    from speaker3d_tpu_torch.models import eres2netv2
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk

    feats = fk.fbank_plain(wav, fb._B, fb._mel,
                           frame_length=fb.cfg.frame_length,
                           frame_shift=fb.cfg.frame_shift)
    feats = feats - feats.mean(dim=-2, keepdim=True)
    kernel, eres2netv2.res2_block = eres2netv2.res2_block, rk.res2_block_plain
    try:
        return model(feats)
    finally:
        eres2netv2.res2_block = kernel


def _flops(fn) -> int:
    """Floating-point operations of the convolutions and matmuls ``fn``
    runs, counted from their shapes (PyTorch's FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def phase_pipeline(work: str) -> dict:
    import torch

    from speaker3d_tpu_torch.cli import infer_diarization
    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn, matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
    from speaker3d_tpu_torch.utils.fileio import write_wav

    wav = synth_conversation()
    wav_path = os.path.join(work, "conv3.wav")
    write_wav(wav_path, wav, FS)
    models = os.path.join(work, "pretrained")
    for seed, model_id in enumerate((MODEL_W24, MODEL_17M)):
        _save_checkpoint(model_id, models, seed)

    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline

    # the pad length L of every embed call: (chunks, L) per call
    pad_lens = []
    emb_extraction = DiarizationPipeline.do_emb_extraction

    def recording(self, chunks, wav_1d):
        out = emb_extraction(self, chunks, wav_1d)
        pad_lens.append((len(chunks), self.last_pad_len))
        return out

    # the main path: both model ids through the CLI, counts read after each
    DiarizationPipeline.do_emb_extraction = recording
    fk.fbank_features.launches = 0
    rk.res2_block.launches = 0
    counts, stage = {}, {}
    for model_id in (MODEL_W24, MODEL_17M):
        pad_lens.clear()
        k1_0, k2_0 = fk.fbank_features.launches, rk.res2_block.launches
        out_dir = os.path.join(work, model_id.split("/")[-1])
        t0 = time.perf_counter()
        infer_diarization.main(["--wav", wav_path, "--out_dir", out_dir,
                                "--model_id", model_id, "--local_model_dir",
                                models, "--sidecar"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[model_id] = (fk.fbank_features.launches - k1_0,
                            rk.res2_block.launches - k2_0)
        rttm = os.path.join(out_dir, "conv3.rttm")
        if not os.path.isfile(rttm) or os.path.getsize(rttm) == 0:
            raise AssertionError(f"{model_id}: no RTTM written")
        with open(os.path.join(out_dir, "conv3.meta.json")) as f:
            meta = json.load(f)
        with open(rttm) as f:
            lines = f.read().splitlines()
        stage[model_id] = {"cli_wall_s": wall, "rtf": meta["rtf"],
                           "segments": len(lines),
                           "speakers": len({ln.split()[7] for ln in lines}),
                           "embed_calls_chunks_pad_len": list(pad_lens)}
        log(f"[pipeline {model_id}] launches K1 {counts[model_id][0]} K2 "
            f"{counts[model_id][1]}; {json.dumps(stage[model_id])}")
        for n_chunks, pad_len in pad_lens:
            log(f"[pipeline {model_id}] embed call: {n_chunks} chunks padded "
                f"to L = {pad_len} samples")
            if pad_len % CHUNK:
                raise AssertionError(f"pad length {pad_len} is not a multiple "
                                     f"of {CHUNK}")
    DiarizationPipeline.do_emb_extraction = emb_extraction
    k1_total = fk.fbank_features.launches
    k2_total = rk.res2_block.launches
    (k1_w, k2_w), (k1_m, k2_m) = counts[MODEL_W24], counts[MODEL_17M]
    if not (k1_w > 0 and k1_m > 0 and k2_w == 0 and k2_m == 7 * k1_m):
        raise AssertionError(f"launch counts {counts}: want K1 > 0 in both "
                             f"runs, K2 0 in w24s4ep4 and 7 per embed batch "
                             f"in the 17.8M run")

    # the pad lengths the path gave its embed calls, and 1.5 s (a short
    # file's): the kernels and the embed call are held at each of them
    lengths = sorted({CHUNK} | {L for m in stage.values()
                                for _, L in m["embed_calls_chunks_pad_len"]})

    # per-stage times of file-level calls, and at each L one batch of
    # embeddings against the plain functions
    for model_id in (MODEL_W24, MODEL_17M):
        model = load_pretrained(model_id, models)
        embed = build_embedding_fn(model, device="cuda", precision="high")
        pipe = DiarizationPipeline(embed, device="cuda")
        # the first call on a fresh model instance (what each CLI process
        # pays), then a second one on the same instance
        walls, stages = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            pipe(wav)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stages.append(dict(pipe.last_stage_times))
        wall = walls[-1]
        stage[model_id].update(first_call_wall_s=walls[0],
                               pad_len=pipe.last_pad_len,
                               first_call_stages_s=stages[0],
                               stages_s=stages[1], warm_wall_s=wall,
                               warm_rtf=wall / (len(wav) / FS),
                               chunks=len(pipe.last_chunks))
        log(f"[pipeline {model_id}] first call {walls[0]:.3f} s (embed "
            f"{stages[0]['embed']:.3f} s, {len(pipe.last_chunks)} chunks "
            f"padded to L = {pipe.last_pad_len}), warm {wall:.3f} s RTF "
            f"{wall / (len(wav) / FS):.5f} stages "
            f"{json.dumps({k: round(v, 4) for k, v in pipe.last_stage_times.items()})}")
        fb = KaldiFbank(FbankConfig(), device="cuda")
        batches = stage[model_id]["embed_batch"] = {}
        for L in lengths:
            starts = np.arange(BATCH) * (len(wav) - L) // BATCH
            batch = torch.from_numpy(
                np.stack([wav[s:s + L] for s in starts])).cuda()
            with torch.inference_mode(), matmul_precision("high"):
                got = embed(batch)
                want = _plain_embed(model, fb, batch)
                embed_ms = cuda_ms(lambda: embed(batch), warmup=2, iters=2,
                                   runs=3)
                plain_ms = cuda_ms(lambda: _plain_embed(model, fb, batch),
                                   warmup=2, iters=2, runs=3)
                # the plain path runs every product as a torch op, so it
                # counts them all
                flops = _flops(lambda: _plain_embed(model, fb, batch))
            cos = float(torch.nn.functional.cosine_similarity(
                got, want, dim=1).min())
            batches[L] = {"ms": embed_ms, "plain_ms": plain_ms,
                          "gflop": flops / 1e9,
                          "fp32_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
                          "min_cosine_kernel_vs_plain": cos}
            log(f"[pipeline {model_id}] embed batch [{BATCH}, {L}]: "
                f"{embed_ms:.3f} ms (plain functions {plain_ms:.3f} ms), "
                f"{flops / 1e9:.1f} GFLOP, {flops / embed_ms / 1e9:.2f} "
                f"TFLOP/s; min cosine kernel vs plain {cos:.7f}")
            if not bool(torch.isfinite(got).all()) or cos < 0.9999:
                raise AssertionError(f"{model_id}: embeddings kernel vs plain "
                                     f"at L = {L}: min cosine {cos}")
            del batch, got, want
    main_len = stage[MODEL_W24]["pad_len"]
    if stage[MODEL_17M]["pad_len"] != main_len:
        raise AssertionError("the two model ids padded the same chunks "
                             "differently")
    return {"k1": k1_total, "k2": k2_total, "stage": stage,
            "lengths": lengths, "main_len": main_len, "models": models}


SV_CHUNK = 10 * FS               # extract's chunk: 10 s at 16 kHz
# utterances of the SV phase, seconds: one shorter than a 400-sample frame,
# one past the 90 s cap
SV_SECONDS = (0.02, 0.4, 1.3, 2.9, 6.5, 10.0, 17.3, 42.0, 95.0)
SV_LONGEST = int(max(SV_SECONDS) * FS)  # exact mode's longest batch-1 call
SV_SPEAKERS = 3
# the throughput corpus: 160 utterances of 80 s, 1,280 10 s chunks, 20 full
# [64, 160000] batches
SV_CORPUS_UTTS, SV_CORPUS_SECONDS = 160, 80.0


def synth_utterance(seconds: float, speaker: int, seed: int) -> np.ndarray:
    """One harmonic 'speaker' (pitch and timbre fixed per speaker) with
    vibrato and noise, seeded; PCM16-exact float32."""
    rng = np.random.default_rng(seed)
    voice = np.random.default_rng(1000 + speaker)
    f0, amps = voice.uniform(100, 300), voice.uniform(0.1, 1.0, 4)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f = f0 * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    phase = 2 * np.pi * np.cumsum(f) / FS
    sig = sum(a * np.sin((k + 1) * phase) for k, a in enumerate(amps))
    wav = 0.25 * sig / amps.sum() + 0.003 * rng.standard_normal(n)
    return (np.round(np.clip(wav, -1, 1 - 1 / 32768) * 32768) / 32768).astype(
        np.float32)


def synth_corpus(folder: str, n_utts: int, seconds: float, seed: int) -> str:
    """A seeded corpus of wavs and its wav.scp (the path returned): each
    utterance one of the SV_SPEAKERS voices of ``synth_utterance``, rolled by
    a random offset, at a random gain, with noise of its own."""
    from speaker3d_tpu_torch.utils.fileio import write_wav

    rng = np.random.default_rng(seed)
    voices = [synth_utterance(seconds, s, seed=seed + s)
              for s in range(SV_SPEAKERS)]
    os.makedirs(folder)
    scp = os.path.join(folder, "wav.scp")
    with open(scp, "w") as f:
        for i in range(n_utts):
            voice = voices[i % SV_SPEAKERS]
            wav = (rng.uniform(0.5, 1.0) * np.roll(voice, int(rng.integers(
                len(voice)))) + 0.002 * rng.standard_normal(len(voice)))
            path = os.path.join(folder, f"c{i}.wav")
            write_wav(path, wav, FS)
            f.write(f"spk{i % SV_SPEAKERS}_c{i} {path}\n")
    return scp


def _counted(fn) -> tuple:
    """Run ``fn`` with the K1 and K2 launch counts set to 0 just before;
    (K1, K2) launches read just after."""
    import torch

    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk

    fk.fbank_features.launches = 0
    rk.res2_block.launches = 0
    fn()
    torch.cuda.synchronize()
    return fk.fbank_features.launches, rk.res2_block.launches


def _min_cosine(got: dict, want: dict, what: str) -> float:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys {sorted(got)} != {sorted(want)}")
    cos = min(float(got[k] @ want[k] / (np.linalg.norm(got[k])
                                        * np.linalg.norm(want[k])))
              for k in want)
    if not cos >= 0.9999:
        raise AssertionError(f"{what}: min cosine {cos} < 0.9999")
    return cos


def _finite_store(path: str) -> dict:
    from speaker3d_tpu_torch.eval.scoring import load_embeddings

    if not os.path.exists(path):
        raise AssertionError(f"missing output {path}")
    embs = load_embeddings(path)
    if not embs or not all(np.isfinite(v).all() for v in embs.values()):
        raise AssertionError(f"{path}: empty or not finite")
    return embs


def phase_sv(work: str, models: str, smi: str) -> dict:
    import torch

    from speaker3d_tpu_torch.cli import (
        compute_score_metrics, extract, infer_sv, infer_sv_batch)
    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn, matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.utils.fileio import write_wav

    sv = os.path.join(work, "sv")
    os.makedirs(sv)
    scp, wavs = os.path.join(sv, "wav.scp"), {}
    with open(scp, "w") as f:
        for i, sec in enumerate(SV_SECONDS):
            utt = f"spk{i % SV_SPEAKERS}_utt{i}"
            wavs[utt] = synth_utterance(sec, i % SV_SPEAKERS, seed=100 + i)
            write_wav(os.path.join(sv, f"{utt}.wav"), wavs[utt], FS)
            f.write(f"{utt} {os.path.join(sv, utt)}.wav\n")
    short = min(wavs, key=lambda u: len(wavs[u]))
    # infer_sv_batch's wav list names one file that does not exist
    wav_list = os.path.join(sv, "wavs.txt")
    with open(wav_list, "w") as f:
        f.writelines(os.path.join(sv, f"{u}.wav\n")
                     for u in sorted(wavs) + ["missing"])
    corpus = synth_corpus(os.path.join(sv, "corpus"), SV_CORPUS_UTTS,
                          SV_CORPUS_SECONDS, seed=200)
    corpus_batches = (SV_CORPUS_UTTS * int(SV_CORPUS_SECONDS * FS) // SV_CHUNK
                      // BATCH)
    common = ["--model_id", MODEL_17M, "--local_model_dir", models]
    runs, stats = {}, {}

    def run(name, fn, embeds):
        t0 = time.perf_counter()
        k1, k2 = _counted(fn)
        wall = time.perf_counter() - t0
        log(f"[sv {name}] launches K1 {k1} K2 {k2}; {wall:.3f} s")
        if not (k1 == embeds if embeds else k1 > 0) or k2 != 7 * k1:
            raise AssertionError(f"sv {name}: launches K1 {k1} K2 {k2}; want "
                                 f"K1 {embeds or '> 0'} and K2 = 7 x K1")
        runs[name] = {"k1": k1, "k2": k2, "wall_s": wall}

    # the main path: the port's own CLIs, the counts read after each run
    out = {m: os.path.join(sv, m) for m in ("ark", "buckets", "exact", "pair",
                                            "batch", "corpus")}
    run("extract chunked ark", lambda: extract.main(
        common + ["--data", scp, "--out_dir", out["ark"], "--out_type", "ark"]),
        None)
    run("extract chunked buckets npz", lambda: extract.main(
        common + ["--data", scp, "--out_dir", out["buckets"], "--buckets",
                  "1.5,3,6,10"]), None)
    run("extract exact", lambda: extract.main(
        common + ["--data", scp, "--out_dir", out["exact"], "--mode",
                  "exact"]), len(wavs) - 1)
    pair = sorted(wavs)[1:3]
    run("infer_sv pair", lambda: infer_sv.main(
        common + ["--wavs"] + [os.path.join(sv, f"{u}.wav") for u in pair]
        + ["--save_dir", out["pair"]]), 2)
    run("infer_sv_batch npy", lambda: infer_sv_batch.main(
        common + ["--wavs", wav_list, "--out_dir", out["batch"]]), None)
    run("extract chunked corpus", lambda: extract.main(
        common + ["--data", corpus, "--out_dir", out["corpus"]]),
        corpus_batches)
    chunked = _finite_store(os.path.join(out["ark"], "embedding_0.scp"))
    bucketed = _finite_store(out["buckets"])
    exact = _finite_store(out["exact"])
    paired = _finite_store(out["pair"])
    if short in exact or len(exact) != len(wavs) - 1:
        raise AssertionError(f"exact mode embedded {sorted(exact)}; want all "
                             f"but {short} (shorter than a frame)")
    if len(_finite_store(out["corpus"])) != SV_CORPUS_UTTS:
        raise AssertionError("the corpus run lost utterances")
    # precision "high" (TF32 outside the kernels) against extract's
    # "highest"; the missing wav skipped
    stats["min_cosine_infer_sv_batch_vs_extract"] = _min_cosine(
        _finite_store(out["batch"]), chunked,
        "sv infer_sv_batch vs extract chunked")

    # scoring over the ark on the card, each printed score against the
    # host's float64 cosine to one unit in its last printed place
    trials = os.path.join(sv, "trials")
    keys = sorted(chunked)
    with open(trials, "w") as f:
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                f.write(f"{a} {b} {int(a.split('_')[0] == b.split('_')[0])}\n")
    scores_dir = os.path.join(sv, "scores")
    data = os.path.join(out["ark"], "embedding_0.scp")
    compute_score_metrics.main(["--enrol_data", data, "--test_data", data,
                                "--trials", trials, "--scores_dir",
                                scores_dir])
    with open(os.path.join(scores_dir, "result.metrics")) as f:
        metrics = f.read()
    unit = {k: v.astype(np.float64) / np.linalg.norm(v.astype(np.float64))
            for k, v in chunked.items()}
    with open(os.path.join(scores_dir, "trials.score")) as f:
        score_err = [abs(float(s) - float(unit[e] @ unit[t]))
                     for e, t, _, s in (line.split() for line in f)]
    stats["score_max_abs_err_vs_host_float64"] = max(score_err)
    if (len(score_err) != len(keys) * (len(keys) - 1) // 2
            or not max(score_err) <= 1e-5 or "nan" in metrics):
        raise AssertionError(f"scores: {len(score_err)}, max error against "
                             f"the host {max(score_err)}; metrics {metrics!r}")
    log(f"[sv compute_score_metrics] {len(score_err)} trials, max abs error "
        f"against the host's float64 {max(score_err):.3g}; "
        f"{' / '.join(metrics.splitlines()[1:])}")

    # the CLI runs against the plain functions: each utterance's plan chunk
    # by chunk (chunked, bucketed), each whole utterance at batch 1 (exact,
    # infer_sv)
    model = load_pretrained(MODEL_17M, models).cuda()
    plain = _plain_fn(model, KaldiFbank(FbankConfig(), device="cuda"))

    for name, got, buckets in (("chunked", chunked, [SV_CHUNK]),
                               ("buckets", bucketed,
                                [24000, 48000, 96000, SV_CHUNK])):
        want = {u: embed_mean_over_plan(plain, w, plan_chunks(
            len(w), buckets, 90 * FS)) for u, w in wavs.items()}
        stats[f"min_cosine_{name}_vs_plain_plan"] = _min_cosine(
            got, want, f"sv {name} vs the plan through the plain functions")
    whole = {u: plain(wavs[u][None])[0].cpu().numpy() for u in exact}
    stats["min_cosine_exact_vs_plain"] = _min_cosine(
        exact, whole, "sv exact vs the plain functions at batch 1")
    stats["min_cosine_infer_sv_vs_plain"] = _min_cosine(
        paired, {u: whole[u] for u in pair},
        "sv infer_sv vs the plain functions at batch 1")

    # one [64, 160000] batch through the kernels against the plain functions
    embed = build_embedding_fn(model, device="cuda", precision="highest")
    rng = np.random.default_rng(7)
    keys_long = [u for u in wavs if len(wavs[u]) >= SV_CHUNK]
    batch = torch.from_numpy(np.stack([
        wavs[u][s:s + SV_CHUNK] for u in rng.choice(keys_long, BATCH)
        for s in [int(rng.integers(0, len(wavs[u]) - SV_CHUNK + 1))]])).cuda()
    with torch.inference_mode(), matmul_precision("highest"):
        got, want = embed(batch), plain(batch)
        cos = float(torch.nn.functional.cosine_similarity(got, want, dim=1).min())
        stats["embed_batch_ms"] = cuda_ms(lambda: embed(batch), warmup=2,
                                          iters=2, runs=3)
        stats["embed_batch_plain_ms"] = cuda_ms(lambda: plain(batch), warmup=2,
                                                iters=2, runs=3)
    stats["embed_batch_min_cosine"] = cos
    if not bool(torch.isfinite(got).all()) or cos < 0.9999:
        raise AssertionError(f"sv [{BATCH}, {SV_CHUNK}] batch kernel vs "
                             f"plain: min cosine {cos}")

    # throughput: the corpus run, every batch full
    audio_s = SV_CORPUS_UTTS * SV_CORPUS_SECONDS
    wall = runs["extract chunked corpus"]["wall_s"]
    stats.update(corpus_audio_s=audio_s, corpus_batches=corpus_batches,
                 throughput_audio_s_per_s=audio_s / wall,
                 corpus_embed_share=(corpus_batches * stats["embed_batch_ms"]
                                     / 1e3 / wall))
    log(f"[sv throughput] {smi}: the extract CLI, chunked, on {audio_s:.0f} s "
        f"of audio ({SV_CORPUS_UTTS} utterances, {corpus_batches} full "
        f"[{BATCH}, {SV_CHUNK}] batches): {wall:.3f} s, "
        f"{stats['throughput_audio_s_per_s']:.1f} audio-s/s (model load and "
        f"wav decode included); embed batch {stats['embed_batch_ms']:.3f} ms "
        f"(plain functions {stats['embed_batch_plain_ms']:.3f} ms, min cosine "
        f"{cos:.7f}), {stats['corpus_embed_share']:.1%} of the run's wall")
    return {"k1": sum(r["k1"] for r in runs.values()),
            "k2": sum(r["k2"] for r in runs.values()),
            "runs": runs, "stats": stats, "scp": scp, "wavs": wavs,
            "stores": out}


# the registry's other backbones at their registry geometry, and the K2
# launches each embed call makes (7: layer1-2 of a scale-2 ERes2Net)
BACKBONES = (("iic/speech_campplus_sv_zh-cn_16k-common", 0),
             ("iic/speech_campplus_sv_en_voxceleb_16k", 0),
             ("iic/speech_eres2net_base_sv_zh-cn_3dspeaker_16k", 7),
             ("iic/speech_eres2net_large_sv_zh-cn_3dspeaker_16k", 7),
             ("iic/speech_eres2net_sv_zh-cn_16k-common", 0),
             ("iic/speech_ecapa-tdnn_sv_zh-cn_cnceleb_16k", 0))


def _plain_fn(model, fb):
    import torch

    from speaker3d_tpu_torch.eval.embedding import matmul_precision

    def plain(x):
        with torch.inference_mode(), matmul_precision("highest"):
            return _plain_embed(model, fb, torch.as_tensor(x, device="cuda"))

    return plain


def phase_backbones(work: str, models: str, sv: dict) -> dict:
    """Each backbone through ``extract`` (chunked) on the SV utterances,
    held against each utterance's plan through the plain functions; one
    [64, 160000] batch through the kernels against the plain functions."""
    import torch

    from speaker3d_tpu_torch.cli import extract
    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn, matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank

    fb = KaldiFbank(FbankConfig(), device="cuda")
    wavs = sv["wavs"]
    rng = np.random.default_rng(9)
    keys_long = [u for u in wavs if len(wavs[u]) >= SV_CHUNK]
    batch = torch.from_numpy(np.stack([
        wavs[u][s:s + SV_CHUNK] for u in rng.choice(keys_long, BATCH)
        for s in [int(rng.integers(0, len(wavs[u]) - SV_CHUNK + 1))]])).cuda()
    out, k1_total, k2_total = {}, 0, 0
    for seed, (model_id, k2_per_call) in enumerate(BACKBONES, start=10):
        _save_checkpoint(model_id, models, seed)
        out_dir = os.path.join(work, "backbones", model_id.split("/")[-1])
        t0 = time.perf_counter()
        k1, k2 = _counted(lambda: extract.main([
            "--model_id", model_id, "--local_model_dir", models, "--data",
            sv["scp"], "--out_dir", out_dir]))
        wall = time.perf_counter() - t0
        if not (k1 > 0 and k2 == k2_per_call * k1):
            raise AssertionError(f"{model_id}: launches K1 {k1} K2 {k2}; want "
                                 f"K1 > 0 and K2 = {k2_per_call} x K1")
        k1_total, k2_total = k1_total + k1, k2_total + k2
        model = load_pretrained(model_id, models).cuda()
        plain = _plain_fn(model, fb)
        got = _finite_store(out_dir)
        want = {u: embed_mean_over_plan(plain, w, plan_chunks(
            len(w), [SV_CHUNK], 90 * FS)) for u, w in wavs.items()}
        cos_cli = _min_cosine(got, want, f"{model_id} extract vs the plan "
                                         f"through the plain functions")
        embed = build_embedding_fn(model, device="cuda", precision="highest")
        with torch.inference_mode(), matmul_precision("highest"):
            e_k, e_p = embed(batch), plain(batch)
            cos = float(torch.nn.functional.cosine_similarity(
                e_k, e_p, dim=1).min())
            ms = cuda_ms(lambda: embed(batch), warmup=1, iters=2, runs=3)
            plain_ms = cuda_ms(lambda: plain(batch), warmup=1, iters=2, runs=3)
        if not bool(torch.isfinite(e_k).all()) or cos < 0.9999:
            raise AssertionError(f"{model_id}: [{BATCH}, {SV_CHUNK}] batch "
                                 f"kernel vs plain: min cosine {cos}")
        n_params = sum(p.numel() for p in model.parameters())
        out[model_id] = {"params_m": n_params / 1e6, "dim": int(e_k.shape[1]),
                         "extract_wall_s": wall, "k1": k1, "k2": k2,
                         "min_cosine_extract_vs_plain": cos_cli,
                         "embed_batch_ms": ms, "embed_batch_plain_ms": plain_ms,
                         "embed_batch_min_cosine": cos}
        log(f"[backbone {model_id}] {n_params / 1e6:.2f}M params, dim "
            f"{e_k.shape[1]}: extract {wall:.3f} s, launches K1 {k1} K2 {k2}, "
            f"min cosine vs plain {cos_cli:.7f}; [{BATCH}, {SV_CHUNK}] batch "
            f"{ms:.3f} ms through the kernels, {plain_ms:.3f} ms plain, min "
            f"cosine {cos:.7f}")
        del model, embed, e_k, e_p
        torch.cuda.empty_cache()

    # the recipe backbones (configs/resnet.yaml, res2net.yaml, xvector.yaml,
    # 80 mel bins, no cut): no registry id, so no CLI; their path is the
    # embed call, K1 and a cuDNN trunk
    for seed, (name, model) in enumerate(_recipe_backbones(), start=30):
        torch.manual_seed(seed)
        model = _random_bn_stats(model, seed)
        embed = build_embedding_fn(model, device="cuda", precision="highest")
        plain = _plain_fn(model, fb)
        k1, k2 = _counted(lambda: embed(batch))
        if not (k1 == 1 and k2 == 0):
            raise AssertionError(f"{name}: launches K1 {k1} K2 {k2}; want K1 "
                                 f"1 and K2 0 per embed batch")
        k1_total += k1
        with torch.inference_mode(), matmul_precision("highest"):
            e_k, e_p = embed(batch), plain(batch)
            cos = float(torch.nn.functional.cosine_similarity(
                e_k, e_p, dim=1).min())
            ms = cuda_ms(lambda: embed(batch), warmup=1, iters=2, runs=3)
            plain_ms = cuda_ms(lambda: plain(batch), warmup=1, iters=2, runs=3)
            gflop = _flops(lambda: plain(batch)) / 1e9
        if not bool(torch.isfinite(e_k).all()) or cos < 0.9999:
            raise AssertionError(f"{name}: [{BATCH}, {SV_CHUNK}] batch kernel "
                                 f"vs plain: min cosine {cos}")
        n_params = sum(p.numel() for p in model.parameters())
        out[name] = {"params_m": n_params / 1e6, "dim": int(e_k.shape[1]),
                     "k1": k1, "k2": k2, "embed_batch_ms": ms,
                     "embed_batch_plain_ms": plain_ms, "gflop": gflop,
                     "embed_batch_min_cosine": cos}
        log(f"[backbone {name}] {n_params / 1e6:.2f}M params, dim "
            f"{e_k.shape[1]}, {gflop:.1f} GFLOP: [{BATCH}, {SV_CHUNK}] batch "
            f"{ms:.3f} ms through the kernels, {plain_ms:.3f} ms plain, min "
            f"cosine {cos:.7f}; launches K1 {k1} K2 {k2}")
        del model, embed, e_k, e_p
        torch.cuda.empty_cache()
    return {"k1": k1_total, "k2": k2_total, "runs": out}


def _recipe_backbones():
    from speaker3d_tpu_torch.models.res2net import Res2Net
    from speaker3d_tpu_torch.models.resnet import ResNet
    from speaker3d_tpu_torch.models.xvector import Xvector

    yield "resnet34 (configs/resnet.yaml)", ResNet(
        feat_dim=80, embedding_size=192, m_channels=32, two_emb_layer=False)
    yield "res2net (configs/res2net.yaml)", Res2Net(
        feat_dim=80, embedding_size=192, m_channels=32)
    yield "xvector (configs/xvector.yaml)", Xvector(feat_dim=80, embed_dim=512)


SERVE_CLIENTS, SERVE_REQUESTS = 8, 40


def _serve_requests(sv_dir: str) -> list:
    """40 seeded requests: (id, waveform, the wav path or None for
    pcm_b64), 0.5-30 s and one of 95 s (past the 90 s cap), every other one
    a wav file."""
    from speaker3d_tpu_torch.utils.fileio import write_wav

    rng = np.random.default_rng(21)
    seconds = list(rng.uniform(0.5, 30.0, SERVE_REQUESTS - 1)) + [95.0]
    reqs = []
    for i, sec in enumerate(seconds):
        wav = synth_utterance(float(sec), i % SV_SPEAKERS, seed=300 + i)
        path = None
        if i % 2 == 0:
            path = os.path.join(sv_dir, f"req{i}.wav")
            write_wav(path, wav, FS)
        reqs.append((f"r{i}", wav, path))
    return reqs


def phase_server(work: str, models: str, smi: str) -> dict:
    """``serve()`` in a thread on TCP port 0 with the 17.8M model; eight
    client threads send 40 mixed-length requests; every embedding against
    its plan through the plain functions; then the CLI as a process."""
    import threading

    import torch

    from speaker3d_tpu_torch.cli.registry import load_pretrained
    from speaker3d_tpu_torch.eval.chunking import embed_mean_over_plan, plan_chunks
    from speaker3d_tpu_torch.eval.embedding import build_embedding_fn
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk
    from speaker3d_tpu_torch.serve import request_embedding, serve

    folder = os.path.join(work, "serve")
    os.makedirs(folder)
    reqs = _serve_requests(folder)
    model = load_pretrained(MODEL_17M, models)
    embed = build_embedding_fn(model, device="cuda", precision="high")
    ready, holder = threading.Event(), []
    thread = threading.Thread(target=serve, args=(embed,), kwargs=dict(
        port=0, ready_event=ready, server_holder=holder), daemon=True)
    thread.start()
    if not ready.wait(timeout=60):
        raise AssertionError("server: not listening after 60 s")
    addr = holder[0].server_address
    got, lat, errors = {}, {}, []
    lock = threading.Lock()

    def client(k):
        for rid, wav, path in reqs[k::SERVE_CLIENTS]:
            t0 = time.perf_counter()
            try:
                e = (request_embedding(addr, wav_path=path, req_id=rid)
                     if path else request_embedding(addr, pcm=wav, req_id=rid))
            except Exception as ex:  # reported below; fails the phase
                with lock:
                    errors.append(f"{rid}: {ex!r}")
                continue
            with lock:
                got[rid], lat[rid] = e, time.perf_counter() - t0

    try:
        embed(np.zeros((16, SV_CHUNK), np.float32))  # warm the batch shape
        torch.cuda.synchronize()
        fk.fbank_features.launches = 0
        rk.res2_block.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        k1, k2 = fk.fbank_features.launches, rk.res2_block.launches
    finally:
        holder[0].shutdown()
        thread.join(timeout=30)
    if errors or len(got) != len(reqs) or any(th.is_alive() for th in threads):
        raise AssertionError(f"server: {len(got)} of {len(reqs)} answered; "
                             f"errors {errors}")
    if not (k1 > 0 and k2 == 7 * k1):
        raise AssertionError(f"server: launches K1 {k1} K2 {k2}; want K1 > 0 "
                             f"and K2 = 7 x K1")
    chunks = sum(len(plan_chunks(len(w), [SV_CHUNK], 90 * FS))
                 for _, w, _ in reqs)
    plain = _plain_fn(model.cuda(), KaldiFbank(FbankConfig(), device="cuda"))
    want = {rid: embed_mean_over_plan(plain, w, plan_chunks(
        len(w), [SV_CHUNK], 90 * FS)) for rid, w, _ in reqs}
    cos = _min_cosine(got, want, "server vs the plan through the plain "
                                 "functions")
    ms = sorted(1e3 * v for v in lat.values())
    stats = {"requests": len(reqs), "clients": SERVE_CLIENTS,
             "chunks": chunks, "audio_s": sum(len(w) for _, w, _ in reqs) / FS,
             "wall_s": wall, "requests_per_s": len(reqs) / wall,
             "p50_ms": float(np.percentile(ms, 50)),
             "p99_ms": float(np.percentile(ms, 99)), "k1": k1, "k2": k2,
             "min_cosine_vs_plain": cos}
    log(f"[serve] {smi}: {len(reqs)} requests from {SERVE_CLIENTS} clients "
        f"({stats['audio_s']:.1f} s of audio, {chunks} chunks of 10 s, batch "
        f"16) in {wall:.3f} s: {stats['requests_per_s']:.2f} requests/s, "
        f"latency p50 {stats['p50_ms']:.1f} ms p99 {stats['p99_ms']:.1f} ms; "
        f"launches K1 {k1} K2 {k2}; min cosine vs plain {cos:.7f}")

    # the CLI as its own process, on the card by default
    rid, wav, _ = reqs[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "speaker3d_tpu_torch.cli.serve_embedding",
         "--port", "0", "--model_id", MODEL_17M, "--local_model_dir", models],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        listening = time.perf_counter() - t0
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        if not m:
            raise AssertionError(f"serve_embedding printed {line!r}")
        e = request_embedding((m.group(1), int(m.group(2))), pcm=wav,
                              req_id=rid)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    stats["cli_listening_s"] = listening
    stats["cli_min_cosine_vs_plain"] = _min_cosine(
        {rid: e}, {rid: want[rid]}, "serve_embedding process vs plain")
    log(f"[serve cli] listening after {listening:.2f} s; one request, cosine "
        f"vs plain {stats['cli_min_cosine_vs_plain']:.7f}")
    return {"k1": k1, "k2": k2, "stats": stats}


def phase_nnchain() -> None:
    import torch

    from speaker3d_tpu_torch.diar.ahc_nnchain import (
        device_linkage_labels, linkage_labels)

    n = 5000
    x, _ = _synth_speakers(n)
    t0 = time.perf_counter()
    dev = device_linkage_labels(x, 0.4, device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = linkage_labels(x, 0.4)
    t_host = time.perf_counter() - t0

    if _partition(dev) != _partition(host):
        raise AssertionError("device NN-chain partition differs from host")
    log(f"[nnchain] N={n} clusters {len(set(dev.tolist()))} device "
        f"{t_dev:.3f} s host {t_host:.3f} s: same partition")


def _synth_speakers(n: int, seed: int = 5, n_spk: int = 12, d: int = 192,
                    spread: float = 0.05):
    """Seeded synthetic speaker embeddings: ``n_spk`` unit directions in
    ``d`` dimensions, each point one of them plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_spk, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_spk, n)
    return (centers[lab] + spread * rng.standard_normal((n, d))).astype(
        np.float32), lab


def _partition(labels) -> list:
    groups = {}
    for i, g in enumerate(np.asarray(labels).tolist()):
        groups.setdefault(g, []).append(i)
    return sorted(tuple(v) for v in groups.values())


def phase_cluster(smi: str) -> dict:
    """Spectral clustering's device path against its host path at N = 1,024
    (dense eigh) and 5,000 (LOBPCG), the CLI's pval and speaker cap; then
    UMAP+HDBSCAN (native, the layout on the card) at N = 2,000."""
    import torch

    from speaker3d_tpu_torch.diar import hdbscan_native, umap_native
    from speaker3d_tpu_torch.diar.cluster import SpectralCluster, UmapHdbscan

    out = {}
    for n, branch in ((1024, "eigh"), (5000, "lobpcg")):
        x, _ = _synth_speakers(n)
        times, labels = {}, {}
        for backend in ("device", "numpy", "device"):  # the second device call is warm
            sc = SpectralCluster(pval=0.012, max_num_spks=15, backend=backend,
                                 random_state=0, device="cuda")
            t0 = time.perf_counter()
            labels[backend] = sc(x)
            torch.cuda.synchronize()
            times.setdefault(backend, []).append(time.perf_counter() - t0)
        if _partition(labels["device"]) != _partition(labels["numpy"]):
            raise AssertionError(f"spectral N={n} ({branch}): device partition "
                                 f"differs from the host's")
        k = len(set(labels["device"].tolist()))
        out[f"spectral_{n}"] = {"branch": branch, "speakers": k,
                                "device_first_s": times["device"][0],
                                "device_s": times["device"][1],
                                "numpy_s": times["numpy"][0]}
        log(f"[cluster spectral] {smi}: N={n} ({branch}) {k} speakers, same "
            f"partition; device {times['device'][1]:.3f} s (first call "
            f"{times['device'][0]:.3f} s), host float64 "
            f"{times['numpy'][0]:.3f} s")

    # UMAP+HDBSCAN: the layout and HDBSCAN timed inside the clusterer's call
    n = 2000
    x, lab = _synth_speakers(n)
    spent = {"layout": 0.0, "hdbscan": 0.0}
    layout_fn, hdb_fn = umap_native.optimize_layout, hdbscan_native.hdbscan_labels

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return r
        return run

    umap_native.optimize_layout = timed("layout", layout_fn)
    hdbscan_native.hdbscan_labels = timed("hdbscan", hdb_fn)
    try:
        t0 = time.perf_counter()
        got = UmapHdbscan(n_neighbors=20, n_components=60, min_samples=20,
                          min_cluster_size=10, backend="native",
                          device="cuda")(x)
        wall = time.perf_counter() - t0
    finally:
        umap_native.optimize_layout, hdbscan_native.hdbscan_labels = (
            layout_fn, hdb_fn)
    noise = float(np.mean(got == -1))
    kept = got != -1
    if noise > 0.01 or _partition(got[kept]) != _partition(lab[kept]):
        raise AssertionError(f"UMAP+HDBSCAN N={n}: noise share {noise}, "
                             f"{len(set(got.tolist()) - {-1})} clusters; want "
                             f"the 12 generating speakers")
    out["umap_hdbscan_2000"] = {"wall_s": wall, "layout_s": spent["layout"],
                                "hdbscan_s": spent["hdbscan"],
                                "noise_share": noise}
    log(f"[cluster umap_hdbscan] {smi}: N={n}, 60 components, 20 neighbours: "
        f"the 12 speakers, noise {noise:.2%}; {wall:.3f} s, of which the "
        f"layout on the card {spent['layout']:.3f} s (500 epochs) and HDBSCAN "
        f"on the host {spent['hdbscan']:.3f} s")
    return out


DIAR_CLUSTER_RUNS = (("spectral_device", ["--cluster_type", "spectral",
                                          "--cluster_backend", "device"]),
                     ("spectral_numpy", ["--cluster_type", "spectral"]),
                     ("umap_hdbscan", ["--cluster_type", "umap_hdbscan"]))
# the file's three speakers as the oracle count, and the centroid merge off:
# random weights put every chunk at cosine > 0.95, so the CLI's default
# --cluster_mer_cos 0.3 would fuse whatever the clusterer found into one
# speaker and the RTTMs would not show it
DIAR_CLUSTER_FLAGS = ["--speaker_num", "3", "--cluster_mer_cos", "1.0"]


def phase_diar_cluster(work: str, models: str, smi: str) -> dict:
    """The diarization CLI with the 17.8M model on the 120 s conversation,
    once per clustering type (the file listed twice: the second call is
    warm); an RTTM from each, scored by compute_der against itself (DER 0)
    and the two spectral RTTMs against each other."""
    from speaker3d_tpu_torch.cli import compute_der, infer_diarization
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline

    wav_path = os.path.join(work, "conv3.wav")
    stages = []
    call = DiarizationPipeline.__call__

    def recording(self, *a, **kw):
        out = call(self, *a, **kw)
        stages.append(dict(self.last_stage_times))
        return out

    runs, rttms, k1, k2 = {}, {}, 0, 0
    DiarizationPipeline.__call__ = recording
    try:
        for name, flags in DIAR_CLUSTER_RUNS:
            stages.clear()
            out_dir = os.path.join(work, f"diar_{name}")
            t0 = time.perf_counter()
            n1, n2 = _counted(lambda: infer_diarization.main(
                ["--wav", wav_path, wav_path, "--out_dir", out_dir,
                 "--model_id", MODEL_17M, "--local_model_dir", models]
                + DIAR_CLUSTER_FLAGS + flags))
            wall = time.perf_counter() - t0
            if not (n1 > 0 and n2 == 7 * n1):
                raise AssertionError(f"diarization {name}: launches K1 {n1} "
                                     f"K2 {n2}; want K1 > 0 and K2 = 7 x K1")
            k1, k2 = k1 + n1, k2 + n2
            rttms[name] = os.path.join(out_dir, "conv3.rttm")
            with open(rttms[name]) as f:
                spk = {line.split()[7] for line in f}
            if not spk:
                raise AssertionError(f"diarization {name}: empty RTTM")
            runs[name] = {"speakers": len(spk), "wall_s": wall, "k1": n1,
                          "k2": n2, "cluster_first_s": stages[0]["cluster"],
                          "cluster_warm_s": stages[1]["cluster"],
                          "embed_warm_s": stages[1]["embed"]}
            log(f"[diarization {name}] {smi}: {len(spk)} speakers; cluster "
                f"stage warm {stages[1]['cluster']:.4f} s (first call "
                f"{stages[0]['cluster']:.4f} s), embed {stages[1]['embed']:.3f} "
                f"s; launches K1 {n1} K2 {n2}")
    finally:
        DiarizationPipeline.__call__ = call
    for name, path in rttms.items():
        der = compute_der.main(["--ref", path, "--hyp", path]).der
        if der != 0.0:
            raise AssertionError(f"compute_der of {name}'s RTTM against itself: "
                                 f"DER {der}")
    cross = compute_der.main(["--ref", rttms["spectral_numpy"], "--hyp",
                              rttms["spectral_device"]]).der
    log(f"[diarization compute_der] each RTTM against itself: DER 0; spectral "
        f"device against spectral host: DER {100 * cross:.2f}%")
    return {"k1": k1, "k2": k2, "runs": runs,
            "der_spectral_device_vs_numpy": cross}


def phase_analysis(work: str, models: str, sv: dict) -> dict:
    """check_single_speaker and analyze_similarity on the card, on the SV
    utterances: each cosine against the host's float64 cosine_affinity of
    the same embeddings, to 1e-5."""
    from speaker3d_tpu_torch.cli import analyze_similarity, check_single_speaker
    from speaker3d_tpu_torch.diar.cluster import cosine_affinity
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline
    from speaker3d_tpu_torch.eval.scoring import load_embeddings

    folder = os.path.join(work, "analysis")
    os.makedirs(folder)
    wavs = [os.path.join(os.path.dirname(sv["scp"]), f"{u}.wav")
            for u in sorted(sv["wavs"]) if len(sv["wavs"][u]) >= 2 * CHUNK]
    wav_list = os.path.join(folder, "wavs.list")
    with open(wav_list, "w") as f:
        f.writelines(w + "\n" for w in wavs)
    embeds, batches = [], []
    extraction = DiarizationPipeline.do_emb_extraction

    def recording(self, chunks, wav_1d):
        out = extraction(self, chunks, wav_1d)
        embeds.append(out)
        batches.append(-(-len(chunks) // self.batch_size))
        return out

    out_json = os.path.join(folder, "single.json")
    DiarizationPipeline.do_emb_extraction = recording
    try:
        k1, k2 = _counted(lambda: check_single_speaker.main(
            ["--wav", wav_list, "--out", out_json, "--model_id", MODEL_17M,
             "--local_model_dir", models]))
    finally:
        DiarizationPipeline.do_emb_extraction = extraction
    if not (len(embeds) == len(wavs) and k1 == sum(batches)
            and k2 == 7 * k1):
        raise AssertionError(f"check_single_speaker: launches K1 {k1} K2 {k2} "
                             f"for {len(embeds)} files; want one per embed "
                             f"batch ({sum(batches)}) and K2 = 7 x K1")
    with open(out_json) as f:
        results = json.load(f)
    err = 0.0
    for r, e in zip(results, embeds):
        aff = cosine_affinity(e)
        for p in r["pairwise_similarities"]:
            err = max(err, abs(p["cosine"] - aff[p["i"], p["j"]]))
    if len(results) != len(wavs) or not err <= 1e-5:
        raise AssertionError(f"check_single_speaker: {len(results)} results, "
                             f"cosine error against the host {err}")
    verdicts = {os.path.basename(r["wav_path"]): r["is_single_speaker"]
                for r in results}

    # analyze_similarity over the bucketed extract run's embeddings
    emb_dir = sv["stores"]["buckets"]
    utt2spk = os.path.join(folder, "utt2spk")
    embs = load_embeddings(emb_dir)
    with open(utt2spk, "w") as f:
        f.writelines(f"{u} {u.split('_')[0]}\n" for u in sorted(embs))
    stats = {"check_single_speaker_files": len(results),
             "check_single_speaker_max_abs_err": err, "verdicts": verdicts}
    for level in ("speaker", "utt"):
        out_dir = os.path.join(folder, f"sim_{level}")
        if analyze_similarity.main(["--emb", emb_dir, "--out_dir", out_dir,
                                    "--utt2spk", utt2spk, "--level", level,
                                    "--min_similarity", "0.0"]) != 0:
            raise AssertionError(f"analyze_similarity --level {level} failed")
        with open(os.path.join(out_dir, "speaker_similarity.json")) as f:
            keys = json.load(f)["keys"]
        if level == "speaker":
            mat = np.stack([np.mean([embs[u].reshape(-1) for u in embs
                                     if u.split("_")[0] == k], axis=0)
                            for k in keys])
        else:
            mat = np.stack([embs[k].reshape(-1) for k in keys])
        sim = np.load(os.path.join(out_dir, "similarity_matrix.npy"))
        e = float(np.abs(sim - cosine_affinity(mat)).max())
        if not e <= 1e-5:
            raise AssertionError(f"analyze_similarity --level {level}: max abs "
                                 f"error against the host's float64 {e}")
        stats[f"analyze_{level}_max_abs_err"] = e
    log(f"[analysis] check_single_speaker on {len(results)} files {verdicts}: "
        f"launches K1 {k1} K2 {k2}, cosines within {err:.3g} of the host's "
        f"float64; analyze_similarity (card, fp32) within "
        f"{stats['analyze_speaker_max_abs_err']:.3g} (speaker) and "
        f"{stats['analyze_utt_max_abs_err']:.3g} (utt) of the host's float64")
    return {"k1": k1, "k2": k2, "stats": stats}


def main() -> int:
    sys.path.insert(0, ROOT)
    device = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="s3d_chip_smoke_") as work:
        pipe = phase_pipeline(work)
        sv = phase_sv(work, pipe["models"], device["smi"])
        backbones = phase_backbones(work, pipe["models"], sv)
        server = phase_server(work, pipe["models"], device["smi"])
        diar_cluster = phase_diar_cluster(work, pipe["models"], device["smi"])
        analysis = phase_analysis(work, pipe["models"], sv)
    lengths = sorted(set(pipe["lengths"]) | {SV_CHUNK})
    k1 = phase_k1(lengths, pipe["main_len"])
    k2 = phase_k2(lengths, pipe["main_len"])
    k3 = phase_k3()
    phase_nnchain()
    cluster = phase_cluster(device["smi"])

    for k, key in ((k1, "k1"), (k2, "k2")):
        k["launches_by_path"] = {"diarization": pipe[key], "sv": sv[key],
                                 "backbones": backbones[key],
                                 "server": server[key],
                                 "diarization_clustering": diar_cluster[key],
                                 "analysis": analysis[key]}
        k["launches"] = sum(k["launches_by_path"].values())
    log(json.dumps({"card": device["smi"], "pipeline": pipe["stage"],
                    "sv": {"runs": sv["runs"], **sv["stats"]},
                    "backbones": backbones["runs"], "server": server["stats"],
                    "diarization_clustering": {
                        k: v for k, v in diar_cluster.items()
                        if k not in ("k1", "k2")},
                    "analysis": analysis["stats"], "cluster": cluster}))
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
