"""online.replay_us: the mean host microseconds of one `graph.replay` span
of the online tracker: the launch of the captured slot step."""

from portbench.metrics._program import durations_ns, window_spans


def read(run):
    d = durations_ns(window_spans(run, "graph.replay"))
    return 1e-3 * sum(d) / len(d) if d else None
