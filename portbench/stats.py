"""The arithmetic of the benchmark's numbers: percentiles, rates, spreads,
and the gate on shares of a peak."""

from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float:
    """The nearest-rank p-th percentile (0 < p <= 100): the smallest value
    with at least p% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return float(xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)])


def rate(count: float, seconds: float) -> float:
    """count per second over a window of `seconds` (> 0)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles
    (statistics.quantiles, n = 4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


class ShareAbovePeak(RuntimeError):
    """A share of a roofline or of a peak read above 100%: its operations or
    bytes are counted too high, or its time leaves out part of the work."""


def gate(name: str, unit: str, value: float) -> float:
    """A share (a metric in %) whose name says it is of a roofline or of a
    peak may not pass 100%; the run fails rather than print it."""
    if unit == "%" and ("roofline" in name or "mfu" in name) and value > 100.0:
        raise ShareAbovePeak(f"{name} reads {value}% (> 100%)")
    return value
