"""Profiling and tracing, port of `open3dsot_tpu/utils/profiling.py`.

- `trace(logdir)`: torch.profiler over the block (host activity, and the
  card's where there is one), its Chrome trace written to
  `logdir/trace.json` as the block ends (Perfetto, chrome://tracing);
- `annotate(name)`: a named span inside such a trace
  (`torch.profiler.record_function`), and an NVTX range where there is a
  card;
- `Stopwatch`: named wall-clock accumulators for the host pipeline (sampler
  against device step), copied.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler, whose trace is written to
    `logdir/trace.json` when the block ends, by an exception too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A span named `name` in a trace, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Stopwatch:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }
