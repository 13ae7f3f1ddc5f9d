"""online.reset_ms: the mean milliseconds of one stream's reset (the
program's `online.reset` span: the first frame's host crop and padding,
the slot's rows written on the card)."""

from portbench.metrics._program import mean_ms


def read(run):
    return mean_ms(run, "online.reset")
