"""k6_roofline: K6's share of its roofline in training, in %: the least time
of the traced window's K6 calls (a step's four forward and four backward
calls, SA layers 2-3 of the template's and the search's backbone at the
step's batch; each call's bytes at 3.35 TB/s or its operations in 3xTF32 at
494.7 TFLOP/s, whichever is longer; portbench/work/bat_kernels.py) over the
device time of K6's kernels (those of csrc/sa_fused_train.cu and
csrc/k6_common.cuh, by name)."""

from portbench import peaks, trace
from portbench.work import bat_kernels

KERNELS = frozenset((
    "row_vectors_kernel", "rowmm_kernel", "dw_kernel", "maxpool_kernel", "maxgrad_kernel",
    "scatter_kernel", "rows_setup_kernel", "rows_max_kernel", "y1_stats_kernel",
    "finalize_fwd_kernel", "finalize_bwd_kernel", "fold_kernel", "sum_partials_kernel",
    "stage_sums_kernel", "finalize_fwd_sums_kernel", "coef_sums_kernel", "da_count_kernel",
    "da_scan_kernel", "da_fill_kernel", "da_sum_kernel"))


def is_k6(name: str) -> bool:
    """Whether a device record's name is one of K6's kernels (the name
    without namespace, template arguments and argument list)."""
    return trace.short_name(name).split("<")[0].split("::")[-1] in KERNELS


def read(run):
    tl = run.counters["timeline"]
    steps = run.counters.get("steps")
    spent = 1e-9 * sum(e - s for s, e, n, _ in tl.device if is_k6(n))
    if not spent or not steps:
        return None
    calls = bat_kernels.k6_calls(run.cfg, int(run.cfg["batch_size"]))
    bound = steps * sum(peaks.tc_bound_s(*f) + peaks.tc_bound_s(*b) for f, b in calls)
    return 100.0 * bound / spent
