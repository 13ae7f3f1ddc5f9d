"""train.build_host_ms_per_step: host milliseconds a training step spends
enqueueing its sample build (the program's `train.sample_build` spans: the
raw batch's copy to the card and the builder's launches), over the
window's steps."""

from portbench.metrics._program import per_step_ms


def read(run):
    return per_step_ms(run, "train.sample_build")
