"""train.mfu: the whole step's share of the card's peak, in %: the model
operations of the traced window's training rows (M2-Track's forward by
closed form, times 3 for the forward and backward; portbench/work/
m2track.py) over the window's length times 164.9 TFLOP/s (494.7 / 3, the
fastest float32-accurate rate)."""

from portbench import peaks
from portbench.work import m2track


def read(run):
    tl = run.counters["timeline"]
    rows = run.counters.get("rows")
    if not rows or tl.window_s <= 0 or not tl.device:
        return None
    flops = rows * m2track.train_flops(int(run.cfg["point_sample_size"]))
    return 100.0 * flops / (tl.window_s * peaks.F32_ACCURATE_FLOPS * len(run.devices))
