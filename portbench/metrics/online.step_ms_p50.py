"""online.step_ms_p50: the median step of the traced window (the benchmark's
span around the resets and `step()` of each step), in ms."""

from portbench import stats


def read(run):
    d = run.spans.durations_s("online.step")
    return 1e3 * stats.percentile(d, 50) if d else None
