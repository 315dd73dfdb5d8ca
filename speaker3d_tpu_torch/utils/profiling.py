"""Training-step profiling.

The counterpart of ``speaker3d_tpu/utils/profiling.py``: ``StepTracer``
wraps ``torch.profiler`` (CPU and CUDA activities) around a window of train
steps and writes a TensorBoard/Chrome trace into ``profile_dir``:

    tracer = StepTracer(profile_dir, start_step=2, num_steps=5)
    for batch in loader:
        tracer.before_step(global_step)
        metrics = train_step(state, batch)
        tracer.after_step(global_step, wait_for=metrics["loss"])

The window starts after the first steps by default, so one-off set-up
(cuDNN autotuning, kernel loading) stays out of it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class StepTracer:
    def __init__(self, profile_dir: Optional[str], start_step: int = 2,
                 num_steps: int = 5):
        self.profile_dir = profile_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None
        self._done = False

    def before_step(self, step: int) -> None:
        if (self.profile_dir and not self._done and self._prof is None
                and step >= self.start):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def after_step(self, step: int, wait_for=None) -> None:
        if self._prof is not None and step + 1 >= self.stop:
            if wait_for is not None and torch.cuda.is_available():
                torch.cuda.synchronize()
            self._finish()
            print(f"profiler trace ({self.start}..{step}) -> "
                  f"{self.profile_dir}")

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))
        self._done = True

    def close(self) -> None:
        """Stop an in-flight trace (the epoch ended inside the window)."""
        if self._prof is not None:
            self._finish()
