"""Spans the benchmark records around its calls into the program, and the
reading of a traced window's device timeline.

Spans are kept in memory: (name, start ns, end ns) by the host's
perf_counter, and in a traced run also as profiler ranges, whose clock is
the device records' clock, so that an idle gap of the device can be named
by what the host was doing. A traced window is one torch.profiler window
(CPU and CUDA activities); its records stay in memory and are read here:
the device's busy intervals (kernels, copies, fills), their union, the
gaps between them, and time by kernel name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"  # the range that marks a traced window


class Spans:
    """The benchmark's spans; `profiled` also opens a profiler range for each."""

    def __init__(self):
        self.records = []  # (name, start_ns, end_ns)
        self.profiled = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.profiled:
            from torch.profiler import record_function

            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.perf_counter_ns()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def durations_s(self, name: str) -> list:
        return [(e - s) * 1e-9 for n, s, e in self.records if n == name]


class Timeline:
    """A traced window's records, read once: device intervals by card, the
    benchmark's ranges, the window's bounds."""

    DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

    def __init__(self, events, span_names=()):
        """`span_names`: the benchmark's range names; their copies on the
        device's timeline (the profiler mirrors a range there) are not work."""
        ranges = set(span_names) | {WINDOW}
        self.device = []  # (start_ns, end_ns, name, card)
        self.ranges = []  # (start_ns, end_ns, name)
        self.window = None
        for e in events:
            name, on_card = e.name(), "CUDA" in str(e.device_type())
            kind = str(e.activity_type()) if hasattr(e, "activity_type") else None
            s = e.start_ns()
            if name in ranges:
                if on_card:
                    continue
                if name == WINDOW:
                    self.window = (s, s + e.duration_ns())
                else:
                    self.ranges.append((s, s + e.duration_ns(), name))
            elif on_card and (kind is None or kind in self.DEVICE_KINDS):
                self.device.append((s, s + e.duration_ns(), name, e.device_index()))
        if self.window is None:
            raise RuntimeError("the traced window's range is missing from the trace")
        w0, w1 = self.window
        self.device = sorted((max(s, w0), min(e, w1), n, d) for s, e, n, d in self.device
                             if e > w0 and s < w1)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def cards(self) -> list:
        return sorted({d for *_, d in self.device})

    def merged(self, card=None) -> list:
        """The union of the device intervals (of one card, or all): [[s, e], ...]."""
        iv = [(s, e) for s, e, _, d in self.device if card is None or d == card]
        if not iv:
            return []
        a = np.array(iv, dtype=np.int64)
        a = a[np.argsort(a[:, 0], kind="stable")]
        reach = np.maximum.accumulate(a[:, 1])
        new = np.ones(len(a), bool)
        new[1:] = a[1:, 0] > reach[:-1]
        starts = a[new, 0]
        last = np.flatnonzero(np.append(new[1:], True))
        return [[int(s), int(e)] for s, e in zip(starts, reach[last])]

    def busy_s(self) -> float:
        """Seconds in which an operation ran, averaged over the cards used."""
        cards = self.cards()
        if not cards:
            return 0.0
        return sum(sum(e - s for s, e in self.merged(d)) for d in cards) * 1e-9 / len(cards)

    def kernel_s(self, names) -> float:
        """Summed device seconds of the operations whose name holds one of `names`."""
        return sum(e - s for s, e, n, _ in self.device if any(k in n for k in names)) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds], ...] of the k operations that took most time."""
        by = defaultdict(int)
        for s, e, n, _ in self.device:
            by[short_name(n)] += e - s
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def _host_labels(self):
        """(boundaries, label of each elementary segment between them): the
        innermost benchmark range over each stretch of the host's time."""
        bounds = sorted({t for s, e, _ in self.ranges for t in (s, e)})
        labels = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            inner = [r for r in self.ranges if r[0] <= lo and hi <= r[1]]
            labels.append(min(inner, key=lambda r: r[1] - r[0])[2] if inner else "no span")
        return np.array(bounds, dtype=np.int64), labels

    def idle_gaps(self, k: int = 10) -> list:
        """[[host activity, seconds], ...]: the first card's idle time inside
        the window, each gap named by the innermost benchmark range open at
        its middle ('no span' where none is), summed by name, the k largest."""
        cards = self.cards()
        busy = np.array(self.merged(cards[0]) if cards else [], dtype=np.int64).reshape(-1, 2)
        w0, w1 = self.window
        g0 = np.concatenate([[w0], busy[:, 1]])
        g1 = np.concatenate([busy[:, 0], [w1]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        bounds, labels = self._host_labels()
        by = defaultdict(int)
        if len(bounds) < 2:
            by["no span"] = int((g1 - g0).sum())
        else:
            mid = (g0 + g1) // 2
            seg = np.searchsorted(bounds, mid, side="right") - 1
            inside = (seg >= 0) & (seg < len(labels))
            names = np.array(labels + ["no span"], dtype=object)[np.where(inside, seg, len(labels))]
            for name in set(names):
                by[name] += int((g1 - g0)[names == name].sum())
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return (name.split("(")[0] or name)[:120]


@contextlib.contextmanager
def traced(spans: Spans, out: dict):
    """Profile the block as one window; out['timeline'] holds its Timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    spans.profiled = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
    spans.profiled = False
    out["timeline"] = Timeline(prof.profiler.kineto_results.events(),
                               {n for n, _, _ in spans.records})
