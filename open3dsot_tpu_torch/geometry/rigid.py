"""Batched rigid-transform math on tensors, port of the part of
`open3dsot_tpu/geometry/rigid.py` (:63-137) that the M2-Track forward uses.

4-DoF boxes are (cx, cy, cz, theta) float32 tensors, z-up. Rotations are
applied as an elementwise product and sum over the 3x3 matrix (no matmul),
so they are exact float32 on every device and TF32 never enters; the JAX
side computes the same einsums at precision HIGHEST.
"""

from __future__ import annotations

import torch


def rotz(t: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 3, 3) rotation matrices about +z."""
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    rows = [
        torch.stack([c, -s, zeros], dim=-1),
        torch.stack([s, c, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """out[b, n, k] = sum_j points[b, n, j] * rot[b, k, j] (einsum bnj,bkj->bnk)."""
    return (points[:, :, None, :] * rot[:, None, :, :]).sum(dim=-1)


def remove_transform_points(points: torch.Tensor, ref_box: torch.Tensor) -> torch.Tensor:
    """Canonicalize points (B, N, 3) into the ref box frame (B, 4)."""
    return _rotate(points - ref_box[:, None, :3], rotz(-ref_box[:, 3]))


def apply_transform_points(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Inverse of remove_transform_points: box frame -> world."""
    return _rotate(points, rotz(box[:, 3])) + box[:, None, :3]


def get_offset_points(points: torch.Tensor, ref_box: torch.Tensor,
                      offset_box: torch.Tensor) -> torch.Tensor:
    """Move points (B, N, 3) rigidly by an offset (B, 4) expressed in the ref
    box (B, 4) frame (reference get_offset_points_tensor)."""
    local = remove_transform_points(points, ref_box)
    local = _rotate(local, rotz(offset_box[:, 3])) + offset_box[:, None, :3]
    return apply_transform_points(local, ref_box)


def get_offset_box(ref_box: torch.Tensor, offset_box: torch.Tensor) -> torch.Tensor:
    """Compose a 4-DoF offset onto a 4-DoF box, (B, 4) -> (B, 4)."""
    off = (rotz(ref_box[:, 3]) * offset_box[:, None, :3]).sum(dim=-1)
    new_angle = ref_box[:, 3] + offset_box[:, 3]
    return torch.cat([off + ref_box[:, :3], new_angle[:, None]], dim=-1)
