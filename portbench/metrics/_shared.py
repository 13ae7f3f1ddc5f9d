"""What several per-layer readers share. A reader is
portbench/metrics/<metric>.py with `read(run) -> float | None`: it reads the
traced run's timeline (`run.counters["timeline"]`, trace.Timeline), the
benchmark's spans (`run.spans`) and the runner's counters, and returns None
where it finds nothing to read."""

from __future__ import annotations


def idle_share(run):
    """The device's idle share of the traced window, in %."""
    tl = run.counters["timeline"]
    if tl.window_s <= 0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)


def device_s(run):
    """Device-seconds busy in the traced window, summed over the cards (None
    where no operation ran on a card)."""
    tl = run.counters["timeline"]
    return tl.busy_s() * len(tl.cards()) if tl.device else None


def span_ms(run, name: str):
    d = run.spans.durations_s(name)
    return None if not d else 1e3 * sum(d) / len(d)
