"""Structured timing + profiling (SURVEY.md section 5).

Counterpart: balm_tpu/utils/tracing.py (PhaseTimers :16, device_trace
:51).  The reference times phases with printf'd ros::Time deltas
(bavoxel.hpp:183, 275-276; benchmark_virtual.cpp:407, 456).  Here: a
phase-timer registry plus a helper around torch.profiler for device
traces.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": self.total[k], "count": self.count[k],
                "mean_s": self.total[k] / max(self.count[k], 1)}
            for k in self.total
        }

    def report(self) -> str:
        lines = []
        for k in sorted(self.total, key=lambda k: -self.total[k]):
            lines.append(
                f"{k:<24s} {self.total[k]:8.3f} s "
                f"({self.count[k]} calls, {self.total[k]/max(self.count[k],1)*1e3:8.2f} ms each)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the block — CPU activity, and
    CUDA kernels where a card is present — and write it into `logdir` as
    a Chrome trace (chrome://tracing or Perfetto).  Yields the trace
    file's path, written when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
