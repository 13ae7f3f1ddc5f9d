"""online.fetch_wait_ms: the median milliseconds a step waits for its boxes
on the host (the program's `online.fetch` span: the copy back, which waits
for the slot step to finish on the card)."""

from portbench.metrics._program import median_ms


def read(run):
    return median_ms(run, "online.fetch")
