"""ctypes bindings of the native host-geometry library (geomlib.cpp), port
of `open3dsot_tpu/native/__init__.py`.

The host loop crops each frame's search area out of a whole sweep
(geometry/points_utils.py::generate_subwindow) and the int16 transfer packs
each scan batch (utils/quant.py::quantize_per_sample); both dispatch here
unless OPEN3DSOT_TPU_NATIVE=0, which takes their numpy paths.

The library is built from this directory's geomlib.cpp with the host
compiler and the JAX package's flags (`g++ -O3 -march=native -shared
-fPIC`) at first use, into `open3dsot_tpu_torch/_build/` (git-ignored),
named by a hash of the source, the flags and the host CPU (-march=native
code may not run on another CPU); later calls and processes reuse it.
Nothing is built at import. A build or load that fails raises with the
compiler's output: the JAX package drops to numpy then, the port does not
(set OPEN3DSOT_TPU_NATIVE=0 to run without a compiler).

Each entry counts its calls (`crop_canonical.calls`, ...), as the kernel
wrappers count their launches; `reset_call_counts()` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "geomlib.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def enabled() -> bool:
    """Whether the host paths take the library (OPEN3DSOT_TPU_NATIVE is not 0)."""
    return os.environ.get("OPEN3DSOT_TPU_NATIVE", "1") != "0"


def _host_cpu() -> bytes:
    """The CPU -march=native builds for: its model and feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = {line for line in f if line.startswith(("model name", "flags"))}
        return "".join(sorted(lines)).encode()
    except OSError:
        return platform.processor().encode()


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build geomlib.cpp if no build of this source, these flags and this
    CPU exists, load it and bind its entries; raises if it cannot."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()
                            + _host_cpu()).hexdigest()[:16]
    out = BUILD_DIR / f"libgeomlib-{digest}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], capture_output=True,
                                      text=True, timeout=120)
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the native host library is built from "
                                   "source at first use (OPEN3DSOT_TPU_NATIVE=0 runs the "
                                   "numpy paths instead)") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    i64, f32p, f64p, u8p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8))
    i16p = ctypes.POINTER(ctypes.c_int16)
    for name, restype, argtypes in (
            ("crop_canonical", i64, [f32p, i64, f64p, f64p, f64p, f32p]),
            ("aabb_mask", i64, [f32p, i64, f64p, f64p, u8p]),
            ("points_in_box", None, [f32p, i64, f64p, f64p, f64p, u8p]),
            ("box_cloud", None, [f32p, i64, f64p, f32p]),
            ("quantize_per_sample", None, [f32p, u8p, i64, i64, i16p, f32p, f32p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True where the host paths take the library, which is then built and
    loaded (a failure raises); False under OPEN3DSOT_TPU_NATIVE=0."""
    if not enabled():
        return False
    library()
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _f64c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _counted(fn):
    """`fn` counting its calls in `.calls`."""
    @functools.wraps(fn)
    def run(*args):
        run.calls += 1
        return fn(*args)

    run.calls = 0
    return run


@_counted
def crop_canonical(points_n3: np.ndarray, rot_world_to_local: np.ndarray,
                   center: np.ndarray, half: np.ndarray) -> np.ndarray:
    """Fused (p - c) @ R^T and strict AABB crop: points (N, 3) -> the kept
    canonical points (K, 3) f32."""
    pts = _f32c(points_n3)
    out = np.empty_like(pts)
    kept = library().crop_canonical(_ptr(pts, ctypes.c_float), len(pts),
                                    _ptr(_f64c(rot_world_to_local), ctypes.c_double),
                                    _ptr(_f64c(center), ctypes.c_double),
                                    _ptr(_f64c(half), ctypes.c_double), _ptr(out, ctypes.c_float))
    return out[:kept]


@_counted
def aabb_mask(points_n3: np.ndarray, mini: np.ndarray, maxi: np.ndarray) -> np.ndarray:
    """Strict world-frame AABB mask (N,) bool of points (N, 3)."""
    pts = _f32c(points_n3)
    mask = np.empty(len(pts), dtype=np.uint8)
    library().aabb_mask(_ptr(pts, ctypes.c_float), len(pts), _ptr(_f64c(mini), ctypes.c_double),
                        _ptr(_f64c(maxi), ctypes.c_double), _ptr(mask, ctypes.c_uint8))
    return mask.astype(bool)


@_counted
def points_in_box_native(points_n3: np.ndarray, rot_world_to_local: np.ndarray,
                         center: np.ndarray, half: np.ndarray) -> np.ndarray:
    """Inclusive oriented in-box mask (N,) bool."""
    pts = _f32c(points_n3)
    mask = np.empty(len(pts), dtype=np.uint8)
    library().points_in_box(_ptr(pts, ctypes.c_float), len(pts),
                            _ptr(_f64c(rot_world_to_local), ctypes.c_double),
                            _ptr(_f64c(center), ctypes.c_double),
                            _ptr(_f64c(half), ctypes.c_double), _ptr(mask, ctypes.c_uint8))
    return mask.astype(bool)


@_counted
def quantize_per_sample_native(pts: np.ndarray, valid: np.ndarray):
    """Single-pass twin of utils/quant.py's numpy encoder, bit for bit (f32
    arithmetic, round half to even): pts (B, ..., 3) f32 and valid (B, ...)
    bool -> (q int16 like pts, scale (B,), off (B, 3))."""
    pts = _f32c(pts)
    B = pts.shape[0]
    flat = pts.reshape(B, -1, 3)
    v = np.ascontiguousarray(np.asarray(valid, bool).reshape(B, -1), dtype=np.uint8)
    q = np.empty(flat.shape, dtype=np.int16)
    scale = np.empty((B,), dtype=np.float32)
    off = np.empty((B, 3), dtype=np.float32)
    library().quantize_per_sample(_ptr(flat, ctypes.c_float), _ptr(v, ctypes.c_uint8), B,
                                  flat.shape[1], _ptr(q, ctypes.c_int16),
                                  _ptr(scale, ctypes.c_float), _ptr(off, ctypes.c_float))
    return q.reshape(pts.shape), scale, off


@_counted
def box_cloud_native(points_n3: np.ndarray, keypoints_9x3: np.ndarray) -> np.ndarray:
    """(N, 3) points, (9, 3) keypoints -> (N, 9) f32 distances."""
    pts = _f32c(points_n3)
    out = np.empty((len(pts), 9), dtype=np.float32)
    library().box_cloud(_ptr(pts, ctypes.c_float), len(pts), _ptr(_f64c(keypoints_9x3),
                                                                   ctypes.c_double),
                        _ptr(out, ctypes.c_float))
    return out


ENTRIES = (crop_canonical, aabb_mask, points_in_box_native, quantize_per_sample_native,
           box_cloud_native)


def reset_call_counts() -> None:
    for fn in ENTRIES:
        fn.calls = 0
