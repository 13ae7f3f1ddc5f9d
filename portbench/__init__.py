"""The benchmark of the PyTorch/CUDA port (portbench/README.md)."""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def cell_threads(argv) -> None:
    """The host's intra-op threads as the cell's configuration states them:
    `assumed.intra_op_threads` of configs/<config>.json, for the cell named
    by `--workload` in `argv`, set for OpenMP, MKL and OpenBLAS (and so for
    torch's pool). Nothing is set where no cell or no such key is found.
    Call before numpy and torch are imported."""
    cell = None
    for i, a in enumerate(argv):
        if a == "--workload" and i + 1 < len(argv):
            cell = argv[i + 1]
        elif a.startswith("--workload="):
            cell = a.split("=", 1)[1]
    try:
        with open(os.path.join(HERE, "workloads", f"{cell}.json")) as f:
            config = json.load(f)["config"]
        with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
            threads = json.load(f).get("assumed", {}).get("intra_op_threads")
    except (OSError, KeyError, ValueError, TypeError):
        return
    if threads is not None:
        for var in THREAD_VARS:
            os.environ[var] = str(int(threads))
