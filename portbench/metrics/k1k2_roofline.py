"""k1k2_roofline: K1/K2's share of their roofline, in %: the least time
their calls in the traced window could take (each call's bytes at 3.35 TB/s
or its operations in 3xTF32 at 494.7 TFLOP/s, whichever is longer;
portbench/work/m2track.py) over the device time of their kernels
(chain_tc_kernel, pool_bias_kernel). Every replay of the step graph makes
its four calls, padded frames too."""

from portbench import peaks
from portbench.work import m2track

KERNELS = ("chain_tc_kernel", "pool_bias_kernel")


def read(run):
    tl = run.counters["timeline"]
    spent = tl.kernel_s(KERNELS)
    loops = run.counters.get("loops")
    if not spent or not loops:
        return None
    n = int(run.cfg["point_sample_size"])
    bound = sum((T - 1) * sum(peaks.tc_bound_s(*c) for c in m2track.step_kernel_calls(B, n))
                for B, T in loops)
    return 100.0 * bound / spent
