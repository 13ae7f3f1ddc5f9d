"""train.sync_wait_ms_per_step: host milliseconds the trainer blocks on the
card (the program's `train.fetch` spans: the loss terms read at log steps,
the epoch's closing synchronisation), over the window's steps."""

from portbench.metrics._program import per_step_ms


def read(run):
    return per_step_ms(run, "train.fetch")
