"""Checks shared by the kernel wrappers (ops/chain_fused.py, ops/sampling.py,
ops/sa_fused.py): which device a call runs on, what a kernel accepts, and
the C return code of a launch."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

# Blocks a CUDA grid may have along y (and z): the kernels that put the batch
# on grid.y (K1/K2, K4/K5) take at most this many clouds a launch, and their
# wrappers split a larger batch (`batch_slices`).
MAX_GRID_Y = 65535


def batch_slices(B: int) -> List[Tuple[int, int]]:
    """[b0, b1) ranges of at most MAX_GRID_Y clouds that cover a batch of B."""
    return [(b0, min(B, b0 + MAX_GRID_Y)) for b0 in range(0, B, MAX_GRID_Y)]


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def direct(x: torch.Tensor) -> bool:
    """Whether a wrapper calls its kernel's CUDA function itself, skipping its
    operator's dispatch (tens of microseconds of host time a call): for a
    CUDA tensor that is not being traced. torch.export and torch.compile
    hand the wrappers tensor subclasses, which go through the operator so
    that a traced program records it."""
    return type(x) is torch.Tensor and x.is_cuda


def check(name: str, t: torch.Tensor, device: torch.device, shape=None,
          dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def raise_on(rc: int, what: str, errors: Optional[Dict[int, str]] = None) -> None:
    """A kernel entry returns 0, a CUDA error code, or a negative code of its own."""
    if rc != 0:
        msg = (errors or {}).get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{what} kernel failed: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
