#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's diarization main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. Imports no JAX. Phases, any failure exits non-zero:

1. the card's name and power limit, the torch and CUDA versions;
2. build both CUDA kernels from ``speaker3d_tpu_torch/csrc`` (one nvcc each,
   in parallel);
3. K1 (fbank) on [64, 24000] against its plain version on the card, with
   the Kaldi-oracle thresholds of the CPU tests; kernel and plain times;
4. K2 (Res2 block) at the four block shapes of the 17.8M model's layer1-2
   (B = 64, 1.5 s chunks) against its plain version, fp32 with TF32 off,
   rtol = atol = 1e-3; times;
5. the port's diarization CLI on a seeded synthetic 120 s three-speaker
   conversation, once with the default ERes2NetV2 w24s4ep4 and once with the
   17.8M ERes2NetV2, both on seeded random weights saved as reference-named
   checkpoints; launch counts (K1 in both runs, K2 7x per embed batch in the
   17.8M run and never in the other) and one batch of embeddings against the
   plain functions on the card (cosine >= 0.9999);
6. the device NN-chain AHC on 5,000 well-separated embeddings against the
   host float64 NN-chain partition.

It prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Times come from CUDA events (median after warm-up) on the card
named in the output.
"""

from __future__ import annotations

import json
import os
import statistics
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
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
MODEL_W24 = "iic/speech_eres2netv2w24s4ep4_sv_zh-cn_16k-common"
MODEL_17M = "iic/speech_eres2netv2_sv_zh-cn_16k-common"


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of one call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
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


def _test_waves(rng, batch: int, n: int):
    t = np.arange(n) / FS
    f0 = rng.uniform(100, 400, size=(batch, 1))
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 3.1 * f0 * t + 0.5)
    wav += 0.02 * rng.standard_normal((batch, n))
    return wav.astype(np.float32)


def phase_k1() -> dict:
    import torch

    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.ops.fbank import FbankConfig, KaldiFbank
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk

    cfg = FbankConfig()
    fb = KaldiFbank(cfg, device="cuda")
    wav = torch.from_numpy(_test_waves(np.random.default_rng(0), BATCH,
                                       CHUNK)).cuda()
    kw = dict(frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
    with torch.inference_mode(), matmul_precision("float32"):
        got = fk.fbank_cuda(wav, fb._B, fb._mel, **kw)
        want = fk.fbank_plain(wav, fb._B, fb._mel, **kw)
        torch.cuda.synchronize()
        err = fbank_oracle_check(got.cpu().numpy(), want.cpu().numpy(),
                                 "K1 vs plain")
        ms = cuda_ms(lambda: fk.fbank_cuda(wav, fb._B, fb._mel, **kw))
        plain = cuda_ms(lambda: fk.fbank_plain(wav, fb._B, fb._mel, **kw))
    T, M = got.shape[1], got.shape[2]
    n_bytes = 4 * (wav.numel() + fb._B.numel() + fb._mel.numel() + got.numel())
    flops = 2 * BATCH * T * (cfg.frame_length * 2 * fk._NB + fk._NB * M)
    b, by = bound_ms(n_bytes, flops)
    log(f"[K1] out {tuple(got.shape)} max_abs_err {err:.3g} kernel {ms:.4f} "
        f"ms plain {plain:.4f} ms bound {b:.4f} ms ({by})")
    return {"name": "fbank", "route": "cuda",
            "source": "speaker3d_tpu_torch/csrc/fbank.cu",
            "replaces": "speaker3d_tpu/ops/pallas/fbank_kernel.py:38",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": None}


# (name, Cin, planes, stride, input F, input T, blocks of this shape) of the
# 17.8M model's layer1-2 at 1.5 s chunks (148 frames): 7 blocks per batch
K2_SHAPES = [("layer1.0", 64, 64, 1, 80, 148, 1),
             ("layer1.1", 128, 64, 1, 80, 148, 2),
             ("layer2.0", 128, 128, 2, 80, 148, 1),
             ("layer2.1", 256, 128, 1, 40, 74, 3)]


def _random_block(cin, planes, stride, gen):
    import torch

    from speaker3d_tpu_torch.models.eres2netv2 import BasicBlockERes2NetV2

    blk = BasicBlockERes2NetV2(cin, planes, stride=stride)
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


def phase_k2() -> list:
    import torch

    from speaker3d_tpu_torch.eval.embedding import matmul_precision
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk

    gen = torch.Generator().manual_seed(1)
    rows = []
    for name, cin, planes, stride, f, t, count in K2_SHAPES:
        blk = _random_block(cin, planes, stride, gen)
        p = blk.folded()
        x = torch.rand((BATCH, cin, f, t), generator=gen).cuda()
        with torch.inference_mode(), matmul_precision("float32"):
            got = rk.res2_block_cuda(x, p, stride)
            want = rk.res2_block_plain(x, p, stride)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
            ms = cuda_ms(lambda: rk.res2_block_cuda(x, p, stride))
            plain = cuda_ms(lambda: rk.res2_block_plain(x, p, stride))
        w, cout = p.width, got.shape[1]
        pos = got.shape[0] * got.shape[2] * got.shape[3]
        flops = 2 * pos * (cin * 2 * w + 2 * 9 * w * w + 2 * w * cout
                           + (cin * cout if p.wsc is not None else 0))
        n_weights = sum(v.numel() for v in (p.k_w1, p.b1, p.k_wc1, p.bc1,
                                            p.k_wc2, p.bc2, p.k_w3, p.b3))
        n_weights += p.k_wsc.numel() if p.k_wsc is not None else 0
        # stride 2 needs only the even rows and columns of x
        n_in = x.numel() // (stride * stride)
        b, by = bound_ms(4 * (n_in + got.numel() + n_weights), flops)
        log(f"[K2 {name}] x {tuple(x.shape)} -> {tuple(got.shape)} max_abs_err "
            f"{err:.3g} kernel {ms:.4f} ms plain {plain:.4f} ms bound {b:.4f} "
            f"ms ({by}) {flops / ms / 1e9:.1f} TFLOP/s")
        rows.append({"shape": name, "blocks": count, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by})
    return rows


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


def _save_checkpoint(model_id: str, root: str, seed: int) -> None:
    import torch

    from speaker3d_tpu_torch.cli.registry import SUPPORTS, build_model

    model = build_model(model_id)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    path = os.path.join(root, model_id, SUPPORTS[model_id]["model_pt"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path)


def _plain_embed(model, fb, wav):
    """The embed call with the plain functions instead of the kernels."""
    import torch

    from speaker3d_tpu_torch.models.pooling import tstp
    from speaker3d_tpu_torch.ops.kernels import fbank_kernel as fk
    from speaker3d_tpu_torch.ops.kernels import res2_block_kernel as rk

    feats = fk.fbank_plain(wav, fb._B, fb._mel,
                           frame_length=fb.cfg.frame_length,
                           frame_shift=fb.cfg.frame_shift)
    feats = feats - feats.mean(dim=-2, keepdim=True)
    x = feats.transpose(1, 2).unsqueeze(1)
    out = torch.relu(model.bn1(model.conv1(x)))
    outs = []
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            out = (rk.res2_block_plain(out, blk.folded(), blk.stride)
                   if blk.fusable else blk(out))
        outs.append(out)
    fuse = model.fuse34(outs[3], model.layer3_ds(outs[2]))
    return model.seg_1(tstp(fuse))


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

    # the main path: both model ids through the CLI, counts read after each
    fk.fbank_features.launches = 0
    rk.res2_block.launches = 0
    counts, stage = {}, {}
    for model_id in (MODEL_W24, MODEL_17M):
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
                           "speakers": len({ln.split()[7] for ln in lines})}
        log(f"[pipeline {model_id}] launches K1 {counts[model_id][0]} K2 "
            f"{counts[model_id][1]}; {json.dumps(stage[model_id])}")
    k1_total = fk.fbank_features.launches
    k2_total = rk.res2_block.launches
    (k1_w, k2_w), (k1_m, k2_m) = counts[MODEL_W24], counts[MODEL_17M]
    if not (k1_w > 0 and k1_m > 0 and k2_w == 0 and k2_m == 7 * k1_m):
        raise AssertionError(f"launch counts {counts}: want K1 > 0 in both "
                             f"runs, K2 0 in w24s4ep4 and 7 per embed batch "
                             f"in the 17.8M run")

    # per-stage times of file-level calls, and one batch of embeddings
    # against the plain functions
    from speaker3d_tpu_torch.diar.pipeline import DiarizationPipeline

    starts = np.arange(BATCH) * (len(wav) - CHUNK) // BATCH
    batch = torch.from_numpy(np.stack([wav[s:s + CHUNK] for s in starts])).cuda()
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
                               first_call_stages_s=stages[0],
                               stages_s=stages[1], warm_wall_s=wall,
                               warm_rtf=wall / (len(wav) / FS))
        fb = KaldiFbank(FbankConfig(), device="cuda")
        with torch.inference_mode(), matmul_precision("high"):
            got = embed(batch)
            want = _plain_embed(model, fb, batch)
            embed_ms = cuda_ms(lambda: embed(batch), warmup=2, iters=10)
            plain_embed_ms = cuda_ms(lambda: _plain_embed(model, fb, batch),
                                     warmup=2, iters=10)
            # the plain path runs every product as a torch op, so it counts
            flops = _flops(lambda: _plain_embed(model, fb, batch))
        cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
        stage[model_id].update(chunks=len(pipe.last_chunks),
                               min_cosine_kernel_vs_plain=float(cos.min()),
                               embed_batch_ms=embed_ms,
                               plain_embed_batch_ms=plain_embed_ms,
                               embed_batch_gflop=flops / 1e9,
                               embed_batch_fp32_bound_ms=(
                                   flops / PEAK_FP32_FLOPS * 1e3))
        log(f"[pipeline {model_id}] first call {walls[0]:.3f} s (embed "
            f"{stages[0]['embed']:.3f} s), warm {wall:.3f} s RTF "
            f"{wall / (len(wav) / FS):.5f} stages "
            f"{json.dumps({k: round(v, 4) for k, v in pipe.last_stage_times.items()})} "
            f"embed batch of {BATCH}: {embed_ms:.3f} ms (plain functions "
            f"{plain_embed_ms:.3f} ms), {flops / 1e9:.1f} GFLOP, "
            f"{flops / embed_ms / 1e9:.2f} TFLOP/s; min cosine kernel vs "
            f"plain {float(cos.min()):.7f}")
        if not bool(torch.isfinite(got).all()) or float(cos.min()) < 0.9999:
            raise AssertionError(f"{model_id}: embeddings kernel vs plain "
                                 f"min cosine {float(cos.min())}")
    return {"k1": k1_total, "k2": k2_total, "stage": stage}


def phase_nnchain() -> None:
    import torch

    from speaker3d_tpu_torch.diar.ahc_nnchain import (
        device_linkage_labels, linkage_labels)

    rng = np.random.default_rng(5)
    n, d, n_spk = 5000, 192, 12
    centers = rng.standard_normal((n_spk, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    lab = rng.integers(0, n_spk, n)
    x = (centers[lab] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    t0 = time.perf_counter()
    dev = device_linkage_labels(x, 0.4, device="cuda")
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = linkage_labels(x, 0.4)
    t_host = time.perf_counter() - t0

    def partition(labels):
        groups = {}
        for i, g in enumerate(labels):
            groups.setdefault(int(g), []).append(i)
        return sorted(tuple(v) for v in groups.values())

    if partition(dev) != partition(host):
        raise AssertionError("device NN-chain partition differs from host")
    log(f"[nnchain] N={n} clusters {len(set(dev.tolist()))} device "
        f"{t_dev:.3f} s host {t_host:.3f} s: same partition")


def main() -> int:
    sys.path.insert(0, ROOT)
    device = phase_device()
    phase_build()
    k1 = phase_k1()
    k2_rows = phase_k2()
    with tempfile.TemporaryDirectory(prefix="s3d_chip_smoke_") as work:
        pipe = phase_pipeline(work)
    phase_nnchain()

    k1["launches"] = pipe["k1"]
    k2 = {"name": "res2_block", "route": "cuda",
          "source": "speaker3d_tpu_torch/csrc/res2_block.cu",
          "replaces": "speaker3d_tpu/ops/pallas/res2_block_kernel.py:143",
          "launches": pipe["k2"],
          "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
          # per embed batch: the 7 launches of layer1-2, by shape
          "ms": sum(r["blocks"] * r["ms"] for r in k2_rows),
          "plain_ms": sum(r["blocks"] * r["plain_ms"] for r in k2_rows),
          "bound_ms": sum(r["blocks"] * r["bound_ms"] for r in k2_rows),
          "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                           for r in k2_rows) else "bytes"),
          "library_ms": None, "shapes": k2_rows}
    log(json.dumps({"card": device["smi"], "pipeline": pipe["stage"]}))
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
