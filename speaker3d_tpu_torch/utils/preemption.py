"""Preemption-safe training.

The counterpart of ``speaker3d_tpu/utils/preemption.py``:
``GracefulShutdown`` turns SIGTERM/SIGINT into a flag the training loop
polls once per step; the trainer then checkpoints the live state and exits
0. Under a process group the poll is collective: every ``poll_interval``
calls the ranks agree (a MAX all-reduce of their flags), so a signal on one
rank stops all of them at the same step boundary instead of leaving the
others in a collective against a peer that has left. The checkpoint carries the previous epoch's label with the
mid-epoch weights and step counter, so recovery re-runs the interrupted
epoch's data order while the schedules resume from the exact step. A second
signal aborts at once (the previous handler).
"""

from __future__ import annotations

import os
import signal
import sys

import torch
import torch.distributed as dist


class GracefulShutdown:
    """Cooperative SIGTERM/SIGINT latch."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 poll_interval: int = 8):
        self.requested = False
        self.poll_interval = max(1, int(poll_interval))
        self._poll_calls = -1
        self._preempted = False
        self._previous = {}
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or an unsupported signal

    def _handler(self, sig, frame):
        if self.requested:  # second signal: give up cooperating
            signal.signal(sig, self._previous.get(sig, signal.SIG_DFL))
            raise KeyboardInterrupt(f"second signal {sig}")
        self.requested = True
        print(f"[preemption] signal {sig} received: will checkpoint and "
              f"exit at the next step boundary", flush=True)

    def poll(self) -> bool:
        """Step-boundary check: the local flag in one process; under a
        process group of several ranks the last collective decision, taken
        anew every ``poll_interval`` calls (every rank calls it at every
        step, so the all-reduces pair up)."""
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self.requested
        self._poll_calls += 1
        if self._poll_calls % self.poll_interval:
            return self._preempted
        # the flag as it was before the collective: a signal that lands
        # during it is taken at the next poll, by every rank alike
        local = bool(self.requested)
        flag = torch.tensor([int(local)], device=(
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else "cpu"))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        decision = bool(flag.item())
        if decision and not local:
            print("[preemption] a peer rank requested shutdown: joining at "
                  "this step boundary", flush=True)
        self.requested = self.requested or decision
        self._preempted = decision
        return decision

    def restore(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    def finalize(self, preempted=None):
        """restore(); then, if a preemption was handled, exit 0 at once: the
        checkpoint is on disk and is the recovery contract. Under a process
        group pass ``preempted``, the collective decision: the local flag
        of a signal that came after the last poll would part the ranks."""
        self.restore()
        if preempted is None:
            preempted = self.requested
        if preempted:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(0)


def save_preemption_checkpoint(checkpointer, epoch_counter, epoch: int,
                               states) -> str:
    """Write the mid-epoch state so that recovery re-runs the interrupted
    epoch: the counter is rewound to epoch - 1 before it is saved."""
    epoch_counter.current = max(epoch - 1, 0)
    d = checkpointer.save_checkpoint(max(epoch - 1, 0), states)
    print(f"[preemption] checkpoint saved to {d}; exiting", flush=True)
    return d
