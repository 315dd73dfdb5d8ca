"""Per-process sharding of host-side work lists."""

from __future__ import annotations

import os
from typing import Optional


def process_rank_count() -> tuple:
    """(rank, count): SPEAKER3D_PROC_INDEX/COUNT (set by local fan-out),
    else RANK/WORLD_SIZE (torchrun), else (0, 1)."""
    for rank_var, count_var in (("SPEAKER3D_PROC_INDEX", "SPEAKER3D_PROC_COUNT"),
                                ("RANK", "WORLD_SIZE")):
        if rank_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ.get(count_var, 1))
    return 0, 1


def process_rank() -> int:
    """This process's shard identity (``process_rank_count``), which names
    its per-rank output files."""
    return process_rank_count()[0]


def process_shard(items, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Round-robin shard of a work list by process (rank::world)."""
    rank, count = process_rank_count()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = count
    return list(items)[process_index::process_count]
