"""scan.replay_us: the mean host microseconds of one `graph.replay` span
inside a scan frame loop: the launch of the captured step."""

from portbench.metrics._program import durations_ns, replays_in_frame_loops


def read(run):
    d = durations_ns(replays_in_frame_loops(run)[1])
    return 1e-3 * sum(d) / len(d) if d else None
