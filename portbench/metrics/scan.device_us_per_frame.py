"""scan.device_us_per_frame: device microseconds busy (the union of the
traced window's kernels, copies and fills, summed over the cards) a real
tracked frame."""

from portbench.metrics._shared import device_s


def read(run):
    frames, busy = run.counters.get("frames"), device_s(run)
    return 1e6 * busy / frames if frames and busy else None
