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
launches the kernel for CUDA tensors; ``probe_<x>.launches`` counts the
launches. ``PROBES`` holds one record per probe: its key, the TPU tool's name
for it, the wrapper, the plain version and its weight.

    python -m speaker3d_tpu_torch.tools.probe_ops                # on the card
    python -m speaker3d_tpu_torch.tools.probe_ops --device cpu   # plain only

Per probe it prints ``[OK]   <name>  sum=<float>`` as the TPU tool does, with
the max abs error against the plain version and, on the card, the kernel's
milliseconds (CUDA events, median). A probe that fails to launch or is out of
tolerance prints ``[FAIL] <name>: ...`` and the tool exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

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
    lib = library("probe_ops")
    if not getattr(lib, "_s3d_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for probe in PROBES.values():
            fn = getattr(lib, f"s3d_probe_{probe.key}")
            fn.restype = i
            # x, [weight,] out, F, T, W, stream
            fn.argtypes = [p] * (2 if probe.weight is None else 3) + [i] * 3 + [p]
        lib._s3d_bound = True
    return lib


def _check_x(x, what: str, min_t: int = 1):
    """What the C entry points cannot see: dtype, layout, and the shape the
    output is allocated from. They check the rest (d and e take W = 26
    only, d T <= 66) and return an error, which ``check`` raises."""
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


def _launch(key: str, out, *tensors):
    f, t, w = tensors[0].shape
    lib = _lib()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib, f"s3d_probe_{key}")(
        *[v.data_ptr() for v in tensors], out.data_ptr(), f, t, w, stream)
    check(lib, rc, f"s3d_probe_{key}")
    PROBES[key].run.launches += 1
    return out


def probe_a_cuda(x):
    _check_x(x, "a", min_t=3)
    f, t, w = x.shape
    return _launch("a", x.new_empty((f, t - 2, w)), x)


def probe_b_cuda(x):
    _check_x(x, "b", min_t=3)
    return _launch("b", torch.empty_like(x), x)


def probe_c_cuda(x):
    _check_x(x, "c")
    return _launch("c", torch.empty_like(x), x)


def probe_d_cuda(x, w9):
    _check_x(x, "d", min_t=3)
    f, t, w = x.shape
    _check_weight(w9, x, (9 * w, w), "d")
    return _launch("d", x.new_empty((f, t - 2, w)), x, w9)


def probe_e_cuda(x, w2):
    _check_x(x, "e")
    w = x.shape[2]
    _check_weight(w2, x, (w, 2 * w), "e")
    return _launch("e", torch.empty_like(x), x, w2)


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


class Probe(NamedTuple):
    key: str
    name: str                # the TPU tool's name for it
    run: Callable            # kernel wrapper (``.launches``)
    plain: Callable          # plain PyTorch version
    weight: Optional[str]    # the ``make_inputs`` key of its weight, if any

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
    """One probe of a ``main`` run: its inputs, the wrapper's and the plain
    version's outputs, and the kernel's median ms (on the card only)."""
    probe: Probe
    args: tuple
    got: Optional[torch.Tensor] = None
    want: Optional[torch.Tensor] = None
    max_abs_err: float = float("nan")
    ms: Optional[float] = None
    error: str = ""          # why the probe failed; empty when it passed


def _run_probe(r: ProbeResult, on_card: bool) -> None:
    r.got, r.want = r.probe.run(*r.args), r.probe.plain(*r.args)
    if on_card:
        torch.cuda.synchronize()
    r.max_abs_err = float((r.got.float() - r.want.float()).abs().max())
    if not within_tolerance(r.probe.key, r.got, r.want):
        raise AssertionError(f"out of tolerance against the plain version: "
                             f"max abs err {r.max_abs_err:.4g}")
    if on_card:
        r.ms = cuda_ms(lambda: r.probe.run(*r.args))


def main(argv=None, results: Optional[list] = None) -> int:
    """Run the five probes; 1 if any failed. ``results``, when given,
    receives one ``ProbeResult`` per probe."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inputs = make_inputs(dev)
    rows = []
    for probe in PROBES.values():
        r = ProbeResult(probe, probe.args(inputs))
        try:
            _run_probe(r, dev.type == "cuda")
            ms = (f"  kernel {r.ms:.4f} ms" if r.ms is not None
                  else "  (cpu: plain version)")
            print(f"[OK]   {probe.name}  sum={float(r.got.float().sum()):.3f}  "
                  f"max_abs_err={r.max_abs_err:.3g}{ms}", flush=True)
        except Exception as e:  # report every probe, then fail the run
            first = (str(e).splitlines() or [""])[0]
            r.error = f"{type(e).__name__}: {first[:160]}"
            print(f"[FAIL] {probe.name}: {r.error}", flush=True)
        rows.append(r)
    if results is not None:
        results.extend(rows)
    return 1 if any(r.error for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
