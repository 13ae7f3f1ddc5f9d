"""online.mfu: the whole step's share of the card's peak while it serves, in
%: the model operations of every slot's forward in the traced window's
steps (BAT's forward by closed form, portbench/work/bat.py) over the time
those steps took (the benchmark's span around each step's resets and
`step()`, issue to boxes on the host) times 164.9 TFLOP/s a card (494.7 / 3,
the fastest float32-accurate rate, 3xTF32). The time between steps, which
the sensor's rate sets, is left out."""

from portbench import peaks
from portbench.work import bat


def read(run):
    spans = run.spans.durations_s("online.step")
    if not spans or sum(spans) <= 0:
        return None
    flops = len(spans) * bat.forward_flops(run.cfg, int(run.counters["slots"]))
    return 100.0 * flops / (sum(spans) * peaks.F32_ACCURATE_FLOPS * len(run.devices))
