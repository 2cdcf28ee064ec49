"""Profiling and step-timing instrumentation (port of the JAX package's
``utils/profiling.py``).

- ``trace(dir, device)``: ``torch.profiler`` around a region, CPU activity
  and, on a CUDA device, the card's kernels (CUPTI), written to ``dir`` as a
  trace that TensorBoard's profiler plugin (and chrome://tracing) loads.
- ``StepTimer``: the host-side rate of training chunks.
- ``TAT_PROFILE_DIR=/path``: the training entry traces its second chunk
  (the first builds and warms up) into that directory.
- ``annotate(name)``: a named region in such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cpu"):
    """Trace the enclosed region into ``log_dir`` (one ``*.pt.trace.json``
    file, written when the region ends). The caller synchronises the device
    inside the region, so that its kernels end there."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def profile_dir_from_env() -> Optional[str]:
    return os.environ.get("TAT_PROFILE_DIR") or None


@dataclass
class StepTimer:
    """Accumulates step counts and wall time across training chunks (the
    device synchronised at each chunk's end)."""

    steps: int = 0
    seconds: float = 0.0
    chunks: List[tuple] = field(default_factory=list)  # (n_steps, seconds)
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float:
        dt = time.perf_counter() - self._t0
        self.steps += n_steps
        self.seconds += dt
        self.chunks.append((n_steps, dt))
        return dt

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.seconds if self.seconds > 0 else 0.0

    @property
    def steady_steps_per_sec(self) -> float:
        """Median per-chunk rate over multi-step chunks, excluding the first
        (which pays the kernels' build and the warm-up that the cumulative
        rate would smear over every step); with a single multi-step chunk
        there is nothing to exclude, so it is used as-is."""
        rates = [n / s for n, s in self.chunks if n > 1 and s > 0]
        if not rates:
            return self.steps_per_sec
        if len(rates) > 1:
            rates = rates[1:]
        return float(np.median(rates))

    def summary(self) -> str:
        return f"{self.steps} steps in {self.seconds:.2f}s ({self.steps_per_sec:.1f} steps/s)"


@contextlib.contextmanager
def annotate(name: str):
    """A named region in a profiler trace (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
