"""train.device_ms_per_step: device milliseconds busy (the union of the
traced window's kernels, copies and fills) a training step: the sample
build, the forward, the backward and Adam."""

from portbench.metrics._shared import device_s


def read(run):
    steps, busy = run.counters.get("steps"), device_s(run)
    return 1e3 * busy / steps if steps and busy else None
