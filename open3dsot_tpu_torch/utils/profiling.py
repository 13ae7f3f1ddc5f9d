"""Profiling and tracing of the port: the span recorder and the profiler.

- `annotate(name, **attrs)`: a span named `name` around a block of the
  program, at its layer boundaries (the scan frame loop, graph replays, the
  online step's parts, the trainer's build, update and fetch). A span
  records only while a torch profiler runs, or inside `recording()` (an
  operator's own window, such as one under nsys); that is its only switch.
  Otherwise the site costs one check of that switch and returns a shared
  do-nothing context: no profiler range, no NVTX range, nothing stored.
  While it records, it opens a profiler range (torch's RecordFunction) and,
  on a machine with a card, an NVTX range of the same name, and stores the
  span: name, start and end in ns, its id, the id of the span it opened
  inside (a stack of each thread's open spans), the thread's id, and the
  small attributes given (card index, B, T).
- The store is a ring of `CAPACITY` spans: the oldest are dropped first
  and counted (`dropped()`). `count(name, n)` adds to a counter under the
  same switch; `active()` reads the switch, for a count that costs a call
  of its own to take. `records()`, `counters()`, `summary()` read them;
  `clear()` empties them.
- Clock: a span is stamped with `time.time_ns()`, the Unix-epoch clock
  (CLOCK_REALTIME) that torch's profiler converts its own records to
  (c10::getTime, against which its ApproximateClockToUnixTimeConverter
  maps its cycle counter). So a span, the profiler's ranges and the card's
  records of one traced window share one time axis; a span lies inside its
  own profiler range.
- `trace(logdir)`: torch.profiler over the block (host activity, and the
  card's where there is one), its Chrome trace written to
  `logdir/trace.json` as the block ends (Perfetto, chrome://tracing), and
  beside it `spans.json`: the block's spans, their summary, the counters
  and the spans dropped, as of the block.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple, Optional

import torch

CAPACITY = 1 << 16  # spans kept: a scan eval pass over 128 tracklets records about 1500


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # the span this one was opened inside, on its thread
    thread: int  # the native thread id
    attrs: dict


class _Off:
    """The context a span site gets while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
# the switch: torch's own flag of a running profiler, or always on inside recording()
_profiler_running = torch._C._autograd._profiler_enabled
_gate = _profiler_running
_forced = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_store: deque = deque(maxlen=CAPACITY)
_counts: dict = defaultdict(int)
_dropped = 0
_nvtx = None  # whether NVTX ranges are opened: decided at the first span recorded


def _always() -> bool:
    return True


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _nvtx
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if _nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = time.time_ns()

    def __exit__(self, *exc):
        global _dropped
        end = time.time_ns()
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(None, None, None)
        _stack().pop()
        span = Span(self.name, self.start, end, self.id, self.parent,
                    threading.get_native_id(), self.attrs)
        with _lock:
            if len(_store) == _store.maxlen:
                _dropped += 1
            _store.append(span)
        return False


def annotate(name: str, **attrs):
    """A span named `name` around the block (see the module's docstring);
    `attrs`: small values stored with it (card, B, T)."""
    if not _gate():
        return _OFF
    return _Span(name, attrs)


def active() -> bool:
    """Whether spans and counters record now."""
    return _gate()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`, under the spans' switch."""
    if _gate():
        with _lock:
            _counts[name] += n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with no torch profiler
    running (an operator's own window)."""
    global _gate, _forced
    with _lock:
        _forced += 1
        _gate = _always
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
            if not _forced:
                _gate = _profiler_running


def records() -> list:
    """The spans stored, oldest first (each ended before the call)."""
    with _lock:
        return list(_store)


def counters() -> dict:
    with _lock:
        return dict(_counts)


def dropped() -> int:
    """The spans the ring has dropped since the last `clear()`."""
    return _dropped


def clear() -> None:
    """Empty the store (a new ring of `CAPACITY` spans), the counters and
    the count of spans dropped."""
    global _store, _dropped
    with _lock:
        _store = deque(maxlen=CAPACITY)
        _counts.clear()
        _dropped = 0


def summary(spans=None) -> dict:
    """name -> {count, total_ns, self_ns} over `spans` (the store's by
    default); a span's self time is its duration less its children's."""
    spans = records() if spans is None else spans
    children = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    out = {}
    for s in spans:
        d = s.end_ns - s.start_ns
        e = out.setdefault(s.name, {"count": 0, "total_ns": 0, "self_ns": 0})
        e["count"] += 1
        e["total_ns"] += d
        e["self_ns"] += d - children.get(s.id, 0)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler, whose trace is written to
    `logdir/trace.json` and the block's spans to `logdir/spans.json` when
    the block ends, by an exception too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0, counts0, dropped0 = time.time_ns(), counters(), dropped()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        spans = [s for s in records() if s.start_ns >= t0]
        counts = {k: v - counts0.get(k, 0) for k, v in counters().items()
                  if v != counts0.get(k, 0)}
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({"spans": [s._asdict() for s in spans], "summary": summary(spans),
                       "counters": counts, "dropped": dropped() - dropped0}, f)
