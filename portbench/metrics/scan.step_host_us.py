"""scan.step_host_us: host microseconds a scan step takes: the program's
`scan.frame_loop` spans (each part's frame loop, one after another on one
host thread where the tracker is split) summed over the graph replays
opened inside them (one a step)."""

from portbench.metrics._program import durations_ns, replays_in_frame_loops


def read(run):
    loops, replays = replays_in_frame_loops(run)
    return 1e-3 * sum(durations_ns(loops)) / len(replays) if replays else None
