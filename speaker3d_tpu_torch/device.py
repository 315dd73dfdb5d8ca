"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument whose default is ``"cuda"``.
There is no silent fall-back: asking for CUDA on a machine without a CUDA
device raises, and the CPU is used only when the caller names it.
"""

from __future__ import annotations

import statistics

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises when CUDA is
    asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_ms(fn, warmup: int = 3, iters: int = 20, runs: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream: ``iters``
    back-to-back calls between one pair of CUDA events, divided by
    ``iters``; the median of ``runs`` such runs, after ``warmup`` untimed
    calls. A call that is short against its launch thus measures how fast
    the card takes launches, not the host's time around one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)
