"""k4_scan_roofline: K4's share of its roofline in the scan eval, in %: the
least time of the traced window's K4 calls (seven a graph replay, one
replay a step of every frame loop, padded frames included, at the loop's
batch; each call's bytes at 3.35 TB/s or its operations in 3xTF32 at 494.7
TFLOP/s, whichever is longer; portbench/work/bat.py) over the device time
of K4's kernels (bq_kernel, sa_tc_kernel)."""

from portbench import peaks
from portbench.work import bat

KERNELS = ("bq_kernel", "sa_tc_kernel")


def read(run):
    tl = run.counters["timeline"]
    spent = tl.kernel_s(KERNELS)
    loops = run.counters.get("loops")
    if not spent or not loops:
        return None
    bound = sum((T - 1) * sum(peaks.tc_bound_s(*c) for c in bat.sa_calls(run.cfg, B))
                for B, T in loops)
    return 100.0 * bound / spent
