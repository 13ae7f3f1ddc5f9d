"""train.mfu.bat: the whole step's share of the card's peak in BAT's
training, in %: the model operations of the traced window's training rows
(BAT's forward by closed form, portbench/work/bat.py, times 3 for the
forward and backward) over the window's length times 164.9 TFLOP/s (494.7
/ 3, the fastest float32-accurate rate)."""

from portbench import peaks
from portbench.work import bat


def read(run):
    tl = run.counters["timeline"]
    rows = run.counters.get("rows")
    if not rows or tl.window_s <= 0 or not tl.device:
        return None
    flops = rows * 3.0 * bat.forward_flops(run.cfg, 1)
    return 100.0 * flops / (tl.window_s * peaks.F32_ACCURATE_FLOPS * len(run.devices))
