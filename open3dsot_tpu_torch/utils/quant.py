"""Fixed-point int16 transfer codec (config.transfer_quant), copy of
`open3dsot_tpu/utils/quant.py`: the host encoder (native, or numpy) and the
device decoder (tensors) of the scan tracker's point transfer.

Per-SAMPLE (leading-axis) ranges: each tracklet gets its own midrange
offset and symmetric scale over its VALID points, so the step is at most
extent / 32766 of that sample's own cloud (about 2 mm at +/-64 m) wherever
the batch members sit in the world frame. Pad rows may clip to the int16
bounds; every consumer masks them with the same validity.
"""

from __future__ import annotations

import numpy as np
import torch

from open3dsot_tpu_torch import native


def quantize_per_sample(pts: np.ndarray, valid: np.ndarray):
    """pts (B, ..., 3) f32 + valid (B, ...) bool -> (q int16 like pts,
    scale (B,), off (B, 3)). Ranges over valid rows per leading-axis sample;
    an all-invalid sample gets off=0, scale=1e-6.

    Takes the single-pass native encoder unless OPEN3DSOT_TPU_NATIVE=0
    (native/geomlib.cpp::quantize_per_sample, bit for bit the numpy path
    below, which makes about eight passes over the batch on the eval
    pipeline's host side)."""
    if native.enabled():
        return native.quantize_per_sample_native(pts, valid)
    return _quantize_per_sample_numpy(pts, valid)


def _quantize_per_sample_numpy(pts: np.ndarray, valid: np.ndarray):
    """The numpy encoder: the native one's plain version."""
    pts = np.asarray(pts, np.float32)
    B = pts.shape[0]
    flat = pts.reshape(B, -1, 3)
    v = np.asarray(valid, bool).reshape(B, -1)[..., None]
    lo = np.where(v, flat, np.inf).min(axis=1)    # (B, 3)
    hi = np.where(v, flat, -np.inf).max(axis=1)
    empty = ~np.isfinite(lo).all(axis=1)
    lo = np.where(empty[:, None], 0.0, lo)
    hi = np.where(empty[:, None], 0.0, hi)
    off = ((lo + hi) * 0.5).astype(np.float32)    # (B, 3)
    scale = np.maximum(
        np.abs(hi - off).max(axis=1) / 32766.0, 1e-6
    ).astype(np.float32)                           # (B,)
    bshape = (B,) + (1,) * (pts.ndim - 2)
    q = np.clip(
        np.rint((pts - off.reshape(bshape + (3,)))
                / scale.reshape(bshape + (1,))),
        -32768, 32767,
    ).astype(np.int16)
    return q, scale, off


def dequantize(q: torch.Tensor, scale: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Device decoder: q (B, ..., 3) int16, scale (B,), off (B, 3) -> f32
    points, the per-sample range broadcast over any rank."""
    bshape = (q.shape[0],) + (1,) * (q.dim() - 2)
    return q.float() * scale.reshape(bshape + (1,)) + off.reshape(bshape + (3,))
