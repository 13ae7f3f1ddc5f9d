"""scan.enqueue_ms_per_batch: host milliseconds a batch's `dispatch_scored`
takes (the benchmark's span around it): pinned copies, every frame's graph
replay enqueued, the scorer enqueued; over the cards one after another
where the tracker is split."""

from portbench.metrics._shared import span_ms


def read(run):
    return span_ms(run, "scan.dispatch_scored")
