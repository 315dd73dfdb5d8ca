"""Local subprocess fan-out for embarrassingly-parallel CLIs.

Re-executes N subprocesses with SPEAKER3D_PROC_INDEX/COUNT set, which
``parallel/mesh.py::process_shard`` reads (the reference's mp.spawn
rank::nprocs file sharding). Each process takes the card its ``--device``
names, so more than one process on one card shares it.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional, Sequence


def maybe_fanout(module: str, argv: Optional[Sequence[str]],
                 nprocs: int) -> bool:
    """If nprocs > 1 and this is the parent, run the rank subprocesses and
    return True (the caller returns); else return False (run inline)."""
    if nprocs <= 1 or "SPEAKER3D_PROC_INDEX" in os.environ:
        return False
    base_argv = list(argv if argv is not None else sys.argv[1:])
    for i, tok in enumerate(base_argv):
        if tok == "--nprocs":
            del base_argv[i:i + 2]
            break
        if tok.startswith("--nprocs="):
            del base_argv[i]
            break
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ,
                   SPEAKER3D_PROC_INDEX=str(rank),
                   SPEAKER3D_PROC_COUNT=str(nprocs))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + base_argv, env=env))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"subprocess exit codes: {codes}")
    return True
