"""What the readers of the program's own spans share. The port records a
span at each of its layer boundaries while a profiler runs
(`open3dsot_tpu_torch/utils/profiling.py`: name, start and end on the
profiler's clock, its id and its parent's); a traced window's spans are
those of `profiling.records()` that overlap the window's range. A program
that records none (no `profiling.records`) gives no spans, and its
readers return None."""

from __future__ import annotations

from portbench import stats


def window_spans(run, name: str = None) -> list:
    """The program's spans inside the traced window (named `name`, or all)."""
    try:
        from open3dsot_tpu_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, "records", None)
    tl = run.counters.get("timeline")
    if records is None or tl is None:
        return []
    w0, w1 = tl.window
    return [s for s in records() if s.start_ns < w1 and s.end_ns > w0
            and (name is None or s.name == name)]


def durations_ns(spans) -> list:
    return [s.end_ns - s.start_ns for s in spans]


def mean_ms(run, name: str):
    d = durations_ns(window_spans(run, name))
    return 1e-6 * sum(d) / len(d) if d else None


def median_ms(run, name: str):
    d = durations_ns(window_spans(run, name))
    return 1e-6 * stats.percentile(d, 50) if d else None


def self_ns(spans: list, name: str) -> int:
    """The summed self time of the spans named `name` among `spans`: each
    one's duration less the part its child spans cover."""
    children = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0) + s.end_ns - s.start_ns
    return sum(s.end_ns - s.start_ns - children.get(s.id, 0) for s in spans if s.name == name)


def replays_in_frame_loops(run) -> tuple:
    """(the window's scan frame loops, the graph replays opened inside them)."""
    spans = window_spans(run)
    loops = [s for s in spans if s.name == "scan.frame_loop"]
    ids = {s.id for s in loops}
    return loops, [s for s in spans if s.name == "graph.replay" and s.parent in ids]


def union(intervals) -> list:
    """[(start, end), ...] merged into disjoint intervals, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_ns(a: list, b: list) -> int:
    """The length two lists of disjoint, sorted intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(tl, card) -> list:
    """The window's stretches in which no operation ran on `card`."""
    w0, w1 = tl.window
    out, t = [], w0
    for s, e in tl.merged(card):
        if s > t:
            out.append([t, s])
        t = max(t, e)
    if w1 > t:
        out.append([t, w1])
    return out


def per_step_ms(run, name: str):
    """The summed time of the spans named `name` over the window's training
    steps (its `train.update` spans)."""
    spans = window_spans(run)
    steps = sum(s.name == "train.update" for s in spans)
    if not steps:
        return None
    return 1e-6 * sum(durations_ns(s for s in spans if s.name == name)) / steps
