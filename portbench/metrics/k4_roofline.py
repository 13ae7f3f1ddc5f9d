"""k4_roofline: K4's share of its roofline, in %: the least time of the
traced window's K4 calls (seven a step; each call's bytes at 3.35 TB/s or
its operations in 3xTF32 at 494.7 TFLOP/s, whichever is longer;
portbench/work/bat.py) over the device time of K4's kernels (the ball
query bq_kernel and the tile kernel sa_tc_kernel)."""

from portbench import peaks
from portbench.work import bat

KERNELS = ("bq_kernel", "sa_tc_kernel")


def read(run):
    tl = run.counters["timeline"]
    spent = tl.kernel_s(KERNELS)
    steps = run.counters.get("steps")
    if not spent or not steps:
        return None
    B = int(run.counters["slots"])
    bound = steps * sum(peaks.tc_bound_s(*c) for c in bat.sa_calls(run.cfg, B))
    return 100.0 * bound / spent
