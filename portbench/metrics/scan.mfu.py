"""scan.mfu: the whole step's share of the card's peak, in %: the model
operations of the real tracked frames in the traced window (M2-Track's
forward by closed form, portbench/work/m2track.py) over the window's length
times 164.9 TFLOP/s a card (494.7 / 3, the fastest float32-accurate rate,
3xTF32)."""

from portbench import peaks
from portbench.work import m2track


def read(run):
    tl = run.counters["timeline"]
    frames = run.counters.get("frames")
    if not frames or tl.window_s <= 0 or not tl.device:
        return None
    flops = frames * m2track.forward_flops(int(run.cfg["point_sample_size"]))
    return 100.0 * flops / (tl.window_s * peaks.F32_ACCURATE_FLOPS * len(run.devices))
