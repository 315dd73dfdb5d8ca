"""Scoped torch intra-op thread count.

A CPU loop of many small torch ops (the UMAP layout's epochs) synchronises
torch's intra-op pool at every op. With other busy processes on the cores
each synchronisation waits for descheduled pool threads, and the loop slows
down by an order of magnitude; one or two threads run it at the speed of an
idle machine. ``cpu_threads`` sets the count for a block and restores the
caller's afterwards, as ``eval/embedding.py::matmul_precision`` scopes the
TF32 flags.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def cpu_threads(n: int):
    """``torch.set_num_threads(n)`` for the block; the caller's count is
    restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(max(1, int(n)))
    try:
        yield
    finally:
        torch.set_num_threads(saved)
