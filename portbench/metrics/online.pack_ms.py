"""online.pack_ms: the median milliseconds a step spends padding and
packing its frames and starting their copies to the card (the program's
`online.pack` span)."""

from portbench.metrics._program import median_ms


def read(run):
    return median_ms(run, "online.pack")
