"""train.update_host_ms_per_step: host milliseconds a training step spends
enqueueing its forward, loss, backward, clip, Adam and schedule step: the
self time of the program's `train.update` spans (less their `train.fetch`),
over the window's steps."""

from portbench.metrics._program import self_ns, window_spans


def read(run):
    spans = window_spans(run)
    steps = sum(s.name == "train.update" for s in spans)
    return 1e-6 * self_ns(spans, "train.update") / steps if steps else None
