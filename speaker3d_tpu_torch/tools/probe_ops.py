"""The Mosaic probe tool's five layout probes as Hopper kernels (K3).

The counterpart of ``tools/probe_mosaic_ops.py``: the same five functions on
the same inputs (x [16, 50, 26], w9 [234, 26], w2 [26, 52], bf16, seeded), as
CUDA C++ kernels (``csrc/probe_ops.cu``) that ask of shared memory and of
the tensor cores' mma fragments what the TPU probes asked of Mosaic:

  a  read of a tile at an unaligned row offset        out = 2 x[:, 1:T-1]
  b  store into a tile at an unaligned row offset      out[:, 2:] = x[:, :T-2]
  c  row tile that does not divide T (flat view)       out = 2 x
  d  3x3 taps from shared memory into mma fragments    conv over (F, T), K = 9W
  e  lane split of an mma output at N = 2W             h[:, :W] + h[:, W:]

Each ``probe_<x>`` takes the plain PyTorch version for CPU tensors and
launches its own kernel for CUDA tensors; ``probe_all`` runs all five in one
launch (``s3d_probe_all``: the probes are launch-bound, so the tool pays the
launch once). ``.launches`` on each counts its launches. ``PROBES`` holds
one record per probe: its key, the TPU tool's name for it, the wrapper, the
plain version, its weight and its bound C entry point.

    python -m speaker3d_tpu_torch.tools.probe_ops                # on the card
    python -m speaker3d_tpu_torch.tools.probe_ops --device cpu   # plain only

The tool runs the fused launch once and, per probe, prints ``[OK]   <name>
sum=<float>`` as the TPU tool does, with the max abs error against the
plain version; on the card, then, the fused launch's milliseconds
(``device.cuda_ms``: many launches between one pair of CUDA events). A
launch that fails or a probe out of tolerance prints ``[FAIL] ...`` and the
tool exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from speaker3d_tpu_torch.device import cuda_ms, resolve_device
from speaker3d_tpu_torch.kernels.build import check, library

F, T, W = 16, 50, 26
DT = torch.bfloat16


def make_inputs(device, seed: int = 0) -> dict:
    """x [F, T, W], w9 [9W, W], w2 [W, 2W] in bf16, from
    ``default_rng(seed)``, ``(seed + 1)`` and ``(seed + 2)`` as in the TPU
    tool."""
    def draw(s, shape):
        a = np.random.default_rng(s).standard_normal(shape)
        return torch.from_numpy(a).to(DT).to(device)

    return {"x": draw(seed, (F, T, W)), "w9": draw(seed + 1, (9 * W, W)),
            "w2": draw(seed + 2, (W, 2 * W))}


# ---- plain versions (bf16; the products accumulate in fp32, TF32 off) ----

def probe_a_plain(x):
    return x[:, 1:-1] * 2


def probe_b_plain(x):
    return nnf.pad(x[:, :-2], (0, 0, 2, 0))


def probe_c_plain(x):
    f, t, w = x.shape
    return (x.reshape(f * t, w) * 2).reshape(f, t, w)


def probe_d_plain(x, w9):
    f, t, w = x.shape
    xp = nnf.pad(x, (0, 0, 0, 0, 1, 1))
    a = torch.cat([xp[df:df + f, dt:dt + t - 2] for df in range(3)
                   for dt in range(3)], dim=-1)
    y = torch.matmul(a.reshape(f * (t - 2), 9 * w).float(), w9.float())
    return y.to(x.dtype).reshape(f, t - 2, w)


def probe_e_plain(x, w2):
    f, t, w = x.shape
    h = torch.matmul(x.reshape(f * t, w).float(), w2.float()).to(x.dtype)
    return (h[:, :w] + h[:, w:]).reshape(f, t, w)


# ---- kernels ----

def _lib():
    """The probe library, each C function bound once (argtypes, restype)
    and kept on its ``Probe`` record."""
    lib = library("probe_ops")
    if not getattr(lib, "_s3d_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for probe in PROBES.values():
            fn = getattr(lib, f"s3d_probe_{probe.key}")
            fn.restype = i
            # x, [weight,] out, F, T, W, stream
            fn.argtypes = [p] * (2 if probe.weight is None else 3) + [i] * 3 + [p]
            probe.fn = fn
        # x, w9, w2, out_a..out_e, F, T, W, stream
        lib.s3d_probe_all.restype = i
        lib.s3d_probe_all.argtypes = [p] * 8 + [i] * 3 + [p]
        lib.s3d_probe_empty.restype = i
        lib.s3d_probe_empty.argtypes = [p]
        lib.s3d_probe_mma_rate.restype = i
        lib.s3d_probe_mma_rate.argtypes = [p] + [i] * 3 + [p]
        lib._s3d_bound = True
    return lib


def _check_x(x, what: str, min_t: int = 1):
    """What the C entry points cannot see: dtype, layout, and the shape the
    output is allocated from. They check the rest (d, e and the fused launch
    take W = 26 only, d and the fused launch T <= 66) and return an error,
    which ``check`` raises."""
    if not x.is_cuda or x.dtype != DT or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"probe {what}: x must be a contiguous bf16 [F, T, W] "
                         f"CUDA tensor")
    if x.shape[2] % 2 or x.shape[1] < min_t:
        raise ValueError(f"probe {what}: needs an even W and T >= {min_t}, "
                         f"got {tuple(x.shape)}")


def _check_weight(wt, x, shape, what: str):
    if (wt.device != x.device or wt.dtype != DT or not wt.is_contiguous()
            or tuple(wt.shape) != shape):
        raise ValueError(f"probe {what}: weight must be a contiguous bf16 "
                         f"{shape} tensor on x's device")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(probe: "Probe", out, *tensors):
    f, t, w = tensors[0].shape
    lib = _lib()
    rc = probe.fn(*[v.data_ptr() for v in tensors], out.data_ptr(), f, t, w,
                  _stream(out))
    check(lib, rc, f"s3d_probe_{probe.key}")
    probe.run.launches += 1
    return out


def probe_a_cuda(x):
    _check_x(x, "a", min_t=3)
    f, t, w = x.shape
    return _launch(PROBES["a"], x.new_empty((f, t - 2, w)), x)


def probe_b_cuda(x):
    _check_x(x, "b", min_t=3)
    return _launch(PROBES["b"], torch.empty_like(x), x)


def probe_c_cuda(x):
    _check_x(x, "c")
    return _launch(PROBES["c"], torch.empty_like(x), x)


def probe_d_cuda(x, w9):
    _check_x(x, "d", min_t=3)
    f, t, w = x.shape
    _check_weight(w9, x, (9 * w, w), "d")
    return _launch(PROBES["d"], x.new_empty((f, t - 2, w)), x, w9)


def probe_e_cuda(x, w2):
    _check_x(x, "e")
    w = x.shape[2]
    _check_weight(w2, x, (w, 2 * w), "e")
    return _launch(PROBES["e"], torch.empty_like(x), x, w2)


def _dispatch(cuda_fn, plain_fn):
    def probe(x, *w):
        """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
        if x.is_cuda:
            return cuda_fn(x, *w)
        if x.device.type != "cpu":
            raise ValueError(f"probe: unsupported device {x.device}")
        return plain_fn(x, *w)

    probe.launches = 0
    return probe


probe_a = _dispatch(probe_a_cuda, probe_a_plain)
probe_b = _dispatch(probe_b_cuda, probe_b_plain)
probe_c = _dispatch(probe_c_cuda, probe_c_plain)
probe_d = _dispatch(probe_d_cuda, probe_d_plain)
probe_e = _dispatch(probe_e_cuda, probe_e_plain)


def probe_all_cuda(x, w9, w2) -> dict:
    """The five probes in one launch of ``s3d_probe_all``: {key: output}."""
    _check_x(x, "all", min_t=3)
    f, t, w = x.shape
    _check_weight(w9, x, (9 * w, w), "all")
    _check_weight(w2, x, (w, 2 * w), "all")
    outs = {"a": x.new_empty((f, t - 2, w)), "b": torch.empty_like(x),
            "c": torch.empty_like(x), "d": x.new_empty((f, t - 2, w)),
            "e": torch.empty_like(x)}
    lib = _lib()
    rc = lib.s3d_probe_all(x.data_ptr(), w9.data_ptr(), w2.data_ptr(),
                           *[o.data_ptr() for o in outs.values()], f, t, w,
                           _stream(x))
    check(lib, rc, "s3d_probe_all")
    probe_all.launches += 1
    return outs


def probe_all(x, w9, w2) -> dict:
    """All five probes: one kernel launch on a CUDA tensor, the five plain
    versions on a CPU tensor. {key: output}."""
    if x.is_cuda:
        return probe_all_cuda(x, w9, w2)
    if x.device.type != "cpu":
        raise ValueError(f"probe: unsupported device {x.device}")
    inputs = {"x": x, "w9": w9, "w2": w2}
    return {key: p.plain(*p.args(inputs)) for key, p in PROBES.items()}


probe_all.launches = 0


def empty_launch(device="cuda") -> None:
    """Launch an empty kernel (one warp) through the same ctypes path: the
    floor under every probe's time."""
    lib = _lib()
    check(lib, lib.s3d_probe_empty(
        torch.cuda.current_stream(device).cuda_stream), "s3d_probe_empty")


MMA_CHAINS = 8  # csrc/probe_ops.cu: independent products per warp per round


def mma_rate_launch(out, blocks: int, threads: int, iters: int) -> int:
    """Launch the mma.sync TF32 rate probe into ``out`` (a float32 CUDA
    tensor of ``blocks * threads``); returns the TF32 m16n8k8 products it
    runs (2 * 16 * 8 * 8 flop each)."""
    if (not out.is_cuda or out.dtype != torch.float32
            or out.numel() != blocks * threads):
        raise ValueError("mma rate probe: out must be a float32 CUDA tensor "
                         "of blocks * threads")
    lib = _lib()
    check(lib, lib.s3d_probe_mma_rate(out.data_ptr(), blocks, threads, iters,
                                      _stream(out)), "s3d_probe_mma_rate")
    return blocks * (threads // 32) * iters * MMA_CHAINS


@dataclass
class Probe:
    key: str
    name: str                # the TPU tool's name for it
    run: Callable            # kernel wrapper (``.launches``)
    plain: Callable          # plain PyTorch version
    weight: Optional[str]    # the ``make_inputs`` key of its weight, if any
    fn: Optional[Callable] = None  # its C entry point, bound by ``_lib``

    def args(self, inputs: dict) -> tuple:
        """The tensors this probe takes, from ``make_inputs``."""
        x = inputs["x"]
        return (x,) if self.weight is None else (x, inputs[self.weight])


PROBES = {p.key: p for p in (
    Probe("a", "a. unaligned sublane ref read", probe_a, probe_a_plain, None),
    Probe("b", "b. unaligned sublane ref store", probe_b, probe_b_plain, None),
    Probe("c", "c. misaligned 3D->2D merge reshape", probe_c, probe_c_plain,
          None),
    Probe("d", "d. concat of ref-loaded pieces + matmul", probe_d,
          probe_d_plain, "w9"),
    Probe("e", "e. unaligned lane slice of matmul out", probe_e,
          probe_e_plain, "w2"),
)}


def within_tolerance(key: str, got, want) -> bool:
    """a-c bit-exact; d and e (fp32 sums in another order, then bf16) within
    2^-8 max|want| everywhere and unequal in at most 1% of elements."""
    if got.shape != want.shape:
        return False
    g, w = got.float(), want.float()
    if key in "abc":
        return bool(torch.equal(g, w))
    diff = (g - w).abs()
    return bool(diff.max() <= 2.0 ** -8 * w.abs().max()
                and (diff > 0).float().mean() <= 0.01)


@dataclass
class ProbeResult:
    """One probe of a ``main`` run: its inputs, the fused launch's and the
    plain version's outputs."""
    probe: Probe
    args: tuple
    got: Optional[torch.Tensor] = None
    want: Optional[torch.Tensor] = None
    max_abs_err: float = float("nan")
    error: str = ""          # why the probe failed; empty when it passed


@dataclass
class ToolRun:
    """What a ``main`` run found: one ``ProbeResult`` per probe, and the
    fused launch's ms (``device.cuda_ms``; on the card only) or why it
    failed."""
    results: list = field(default_factory=list)
    ms: Optional[float] = None
    error: str = ""


def _first_line(e: Exception) -> str:
    return f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:160]}"


def main(argv=None, run: Optional[ToolRun] = None) -> int:
    """Run the five probes in one launch (``probe_all``) and hold each
    output against its plain version; 1 if any failed. ``run``, when given,
    receives what the run found."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inputs = make_inputs(dev)
    run = ToolRun() if run is None else run
    try:
        outs = probe_all(inputs["x"], inputs["w9"], inputs["w2"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except Exception as e:  # report the launch, then fail the run
        run.error = _first_line(e)
        print(f"[FAIL] fused launch: {run.error}", flush=True)
        return 1
    for probe in PROBES.values():
        r = ProbeResult(probe, probe.args(inputs), outs[probe.key],
                        probe.plain(*probe.args(inputs)))
        r.max_abs_err = float((r.got.float() - r.want.float()).abs().max())
        if within_tolerance(probe.key, r.got, r.want):
            print(f"[OK]   {probe.name}  sum={float(r.got.float().sum()):.3f}  "
                  f"max_abs_err={r.max_abs_err:.3g}", flush=True)
        else:
            r.error = (f"out of tolerance against the plain version: max abs "
                       f"err {r.max_abs_err:.4g}")
            print(f"[FAIL] {probe.name}: {r.error}", flush=True)
        run.results.append(r)
    if dev.type == "cuda":
        run.ms = cuda_ms(lambda: probe_all(inputs["x"], inputs["w9"],
                                           inputs["w2"]))
        print(f"fused launch (all five probes): {run.ms:.4f} ms", flush=True)
    return 1 if any(r.error for r in run.results) else 0


if __name__ == "__main__":
    sys.exit(main())
