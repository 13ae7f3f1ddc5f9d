"""scan.mfu.bat: the whole step's share of the card's peak in BAT's scan
eval, in %: the model operations of the real tracked frames in the traced
window (BAT's forward by closed form, portbench/work/bat.py) over the
window's length times 164.9 TFLOP/s a card (494.7 / 3, the fastest
float32-accurate rate, 3xTF32)."""

from portbench import peaks
from portbench.work import bat


def read(run):
    tl = run.counters["timeline"]
    frames = run.counters.get("frames")
    if not frames or tl.window_s <= 0 or not tl.device:
        return None
    flops = frames * bat.forward_flops(run.cfg, 1)
    return 100.0 * flops / (tl.window_s * peaks.F32_ACCURATE_FLOPS * len(run.devices))
