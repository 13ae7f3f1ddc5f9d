"""k3_scan_roofline: K3's share of its roofline in the scan eval, in %: the
least time of the traced window's K3 calls (two a graph replay, the
template's and the search's farthest-point sampling, one replay a step of
every frame loop, padded frames included; each call's bytes at 3.35 TB/s or
its operations at 67 TFLOP/s float32, whichever is longer;
portbench/work/bat_kernels.py) over the device time of K3's kernels. FPS
is a chain of dependent steps, so the share reads far under 1%: it is read
for its change."""

from portbench import peaks
from portbench.work import bat_kernels

KERNELS = ("fps_kernel", "fps_cluster_kernel")


def read(run):
    tl = run.counters["timeline"]
    spent = tl.kernel_s(KERNELS)
    loops = run.counters.get("loops")
    if not spent or not loops:
        return None
    bound = sum((T - 1) * sum(peaks.bound_s(*c) for c in bat_kernels.k3_calls(run.cfg, B))
                for B, T in loops)
    return 100.0 * bound / spent
