"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under `open3dsot_tpu_torch/csrc/` have a plain C interface, so
they build in seconds without PyTorch's headers; `*.cuh` there are headers
that several sources include. The shared library goes
into `open3dsot_tpu_torch/_build/` (git-ignored), named by a hash of the
source and flags, at first use; later calls and processes reuse it. Nothing
here runs at import: the CPU tests import every module, and this machine
may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of each library's entries: argtypes, restype int unless
# given as (argtypes, restype).
SIGNATURES = {
    "chain_fused": {
        "chain_fused_workspace": ([_PI, _I, _I, _I], _LL),
        "chain_fused_k1": [_P, _P, _LL, _PI, _I, _I, _I, _I, _P, _P, _P, _LL, _P],
        "chain_fused_k2": [_P, _P, _P, _P, _LL, _PI, _I, _I, _I, _I, _P, _P, _P, _LL, _P],
    },
    "chain_fused_bf16": {
        "chain_fused_bf16_workspace": ([_PI, _I, _I, _I], _LL),
        "chain_fused_k1_bf16": [_P, _P, _LL, _PI, _I, _I, _I, _I, _P, _P, _P, _LL, _P],
        "chain_fused_k2_bf16": [_P, _P, _P, _P, _LL, _PI, _I, _I, _I, _I, _P, _P, _P, _LL, _P],
    },
    "fps": {
        "fps_k3": [_P, _I, _I, _I, _I, _I, _I, _P, _P],
        "fps_k3_cluster": [_P, _I, _I, _I, _I, _P, _P],
    },
    "fps_floor": {
        "fps_chain_floor": [_I, _I, _I, _P, _P],
    },
    "gather_probe": {
        "gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "gather_elems": [_P, _P, _P, _I, _I, _I, _I, _P],
        "onehot_rowsums": [_P, _P, _I, _I, _I, _I, _P],
        "gather_bf16_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "sa_fused": {
        "sa_fused_k4": [_P] * 8 + [_LL, _P, _P, _LL, _P, _P] + [_I] * 7 + [_F, _F, _I, _P],
    },
    "sa_fused_bf16": {
        "sa_fused_k4_bf16": [_P] * 8 + [_LL, _P, _P, _LL, _P, _P] + [_I] * 7 + [_F, _F, _P],
    },
    "sa_fused_train": {
        "sa_train_workspace": ([_I] * 8, _LL),
        "sa_train_packed_floats": ([_I] * 2, _LL),
        "sa_train_fwd": [_P] * 4 + [_LL, _P, _P, _LL] + [_P] * 7 + [_I] * 7 + [_P],
        "sa_train_bwd": [_P] * 8 + [_LL, _P, _LL] + [_P] * 7 + [_I] * 8 + [_P],
        "sa_train_fwd_staged": [_P] * 4 + [_LL, _P, _P, _LL] + [_P] * 7 + [_I] * 8 + [_P, _P],
        "sa_train_bwd_staged": [_P] * 8 + [_LL, _P, _LL] + [_P] * 7 + [_I] * 9 + [_P, _P],
        "sa_rows_workspace": ([_I] * 7, _LL),
        "sa_rows_eval": [_P] * 7 + [_LL, _P, _P, _LL, _P, _P, _P] + [_I] * 7 + [_F, _F, _I, _P],
    },
    "sa_fused_train_bf16": {
        "sa_train_bf16_workspace": ([_I] * 8, _LL),
        "sa_train_bf16_fwd": [_P] * 14 + [_I] * 7 + [_P],
        "sa_train_bf16_bwd": [_P] * 21 + [_I] * 8 + [_P],
        "sa_train_bf16_fwd_staged": [_P] * 14 + [_I] * 8 + [_P, _P],
        "sa_train_bf16_bwd_staged": [_P] * 21 + [_I] * 9 + [_P, _P],
    },
}


class KernelLibrary:
    """A loaded kernel library: its ctypes handle and how it was built."""

    def __init__(self, name: str, path: Path, build_seconds: float, build_log: str):
        self.name = name
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an earlier build was reused
        self.build_log = build_log  # nvcc's output, with -Xptxas -v register/spill lines
        self.lib = ctypes.CDLL(str(path))
        for fn, sig in SIGNATURES[name].items():
            argtypes, restype = sig if isinstance(sig, tuple) else (sig, ctypes.c_int)
            f = getattr(self.lib, fn)
            f.argtypes = argtypes
            f.restype = restype


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at first use")


def load_libraries(names) -> Dict[str, KernelLibrary]:
    """Build (one nvcc process each, side by side) and load several libraries."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(load_library, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> KernelLibrary:
    """Build `csrc/<name>.cu` if no build of this source exists, then load it."""
    src = CSRC / f"{name}.cu"
    # the headers the sources share (csrc/*.cuh) are part of every build's identity
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.is_file():
        return KernelLibrary(name, out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return KernelLibrary(name, out, time.perf_counter() - t0, proc.stdout + proc.stderr)
