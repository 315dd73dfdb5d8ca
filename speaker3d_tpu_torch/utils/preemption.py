"""Preemption-safe training on one host.

The counterpart of ``speaker3d_tpu/utils/preemption.py`` for a single
process: ``GracefulShutdown`` turns SIGTERM/SIGINT into a flag the training
loop polls once per step; the trainer then checkpoints the live state and
exits 0. The checkpoint carries the previous epoch's label with the
mid-epoch weights and step counter, so recovery re-runs the interrupted
epoch's data order while the schedules resume from the exact step. A second
signal aborts at once (the previous handler).
"""

from __future__ import annotations

import os
import signal
import sys


class GracefulShutdown:
    """Cooperative SIGTERM/SIGINT latch."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
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
        """Step-boundary check (one process: the local flag)."""
        return self.requested

    def restore(self):
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

    def finalize(self, preempted=None):
        """restore(); then, if a preemption was handled, exit 0 at once: the
        checkpoint is on disk and is the recovery contract."""
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
