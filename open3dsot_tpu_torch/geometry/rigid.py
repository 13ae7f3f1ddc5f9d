"""Batched rigid-transform math on tensors, port of
`open3dsot_tpu/geometry/rigid.py`.

4-DoF boxes are (cx, cy, cz, theta) float32 tensors whose rotation is
`A @ Rz(theta)`, where `A` is the constant change of basis of the dataset's
up convention (`up_frame`): None for z-up, Rx(pi/2) for the camera frame
(up_axis [0, -1, 0]). Composing a box-local z offset is theta += delta in
both conventions, so the scan tracker's recurrence takes either basis.

Rotations are applied as an elementwise product and sum over the 3x3
matrix (no matmul), so they are exact float32 on every device and TF32 never
enters; the JAX side computes the same einsums at precision HIGHEST.
`theta_from_rotation` and `rotation_from_theta` are numpy host functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def up_frame(up_axis, device=None) -> Optional[torch.Tensor]:
    """Constant basis A for a config's up_axis (None = identity = z-up)."""
    up = np.asarray(up_axis, dtype=np.float64)
    up = up / np.linalg.norm(up)
    if np.allclose(up, [0, 0, 1]):
        return None
    if np.allclose(up, [0, -1, 0]):
        # Rx(pi/2): maps box-local +z to world (0, -1, 0)
        return torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
                            device=device)
    raise ValueError(f"unsupported up_axis {up_axis!r}; expected [0,0,1] or [0,-1,0]")


def theta_from_rotation(rotation_matrix: np.ndarray, A=None) -> float:
    """Recover theta with R = A @ Rz(theta) from a host rotation matrix."""
    R = np.asarray(rotation_matrix, dtype=np.float64)
    if A is not None:
        R = np.asarray(A, dtype=np.float64).T @ R
    return float(np.arctan2(R[1, 0], R[0, 0]))


def rotation_from_theta(theta: float, A=None) -> np.ndarray:
    """Host-side inverse of theta_from_rotation: A @ Rz(theta) as numpy."""
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    if A is not None:
        R = np.asarray(A, dtype=np.float64) @ R
    return R


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


def roty(t: torch.Tensor) -> torch.Tensor:
    """(...,) angles -> (..., 3, 3) rotation matrices about +y."""
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    rows = [
        torch.stack([c, zeros, s], dim=-1),
        torch.stack([zeros, ones, zeros], dim=-1),
        torch.stack([-s, zeros, c], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """out[b, n, k] = sum_j points[b, n, j] * rot[b, k, j] (einsum bnj,bkj->bnk)."""
    return (points[:, :, None, :] * rot[:, None, :, :]).sum(dim=-1)


def _basis(p: torch.Tensor, A: torch.Tensor, transpose: bool) -> torch.Tensor:
    """p @ A (einsum bnj,jk->bnk), or p @ A^T (bnj,kj->bnk) with transpose."""
    A = A.to(p.dtype)
    return (p[..., :, None] * A[None, None]).sum(dim=-2) if not transpose else \
        (p[..., None, :] * A[None, None]).sum(dim=-1)


def remove_transform_points(points: torch.Tensor, ref_box: torch.Tensor,
                            A=None) -> torch.Tensor:
    """Canonicalize points (B, N, 3) into the ref box frame (B, 4)."""
    p = points - ref_box[:, None, :3]
    if A is not None:
        # local = Rz(-t) A^T p  (row form: p @ A @ Rz(-t)^T)
        p = _basis(p, A, transpose=False)
    return _rotate(p, rotz(-ref_box[:, 3]))


def apply_transform_points(points: torch.Tensor, box: torch.Tensor, A=None) -> torch.Tensor:
    """Inverse of remove_transform_points: box frame -> world."""
    p = _rotate(points, rotz(box[:, 3]))
    if A is not None:
        p = _basis(p, A, transpose=True)
    return p + box[:, None, :3]


def get_offset_points(points: torch.Tensor, ref_box: torch.Tensor,
                      offset_box: torch.Tensor, A=None) -> torch.Tensor:
    """Move points (B, N, 3) rigidly by an offset (B, 4) expressed in the ref
    box (B, 4) frame (reference get_offset_points_tensor)."""
    local = remove_transform_points(points, ref_box, A=A)
    local = _rotate(local, rotz(offset_box[:, 3])) + offset_box[:, None, :3]
    return apply_transform_points(local, ref_box, A=A)


def get_offset_box(ref_box: torch.Tensor, offset_box: torch.Tensor, A=None) -> torch.Tensor:
    """Compose a 4-DoF offset onto a 4-DoF box, (B, 4) -> (B, 4)."""
    off = (rotz(ref_box[:, 3]) * offset_box[:, None, :3]).sum(dim=-1)
    if A is not None:
        off = (A.to(off.dtype)[None] * off[:, None, :]).sum(dim=-1)
    new_angle = ref_box[:, 3] + offset_box[:, 3]
    return torch.cat([off + ref_box[:, :3], new_angle[:, None]], dim=-1)


def box_corners(box: torch.Tensor, wlh: torch.Tensor, wlh_factor: float = 1.0,
                A=None) -> torch.Tensor:
    """(B, 4) boxes + (B, 3) sizes -> (B, 8, 3) corners, in the host
    Box.corners() order (first four forward, last four backward)."""
    w, l, h = wlh[:, 0] * wlh_factor, wlh[:, 1] * wlh_factor, wlh[:, 2] * wlh_factor
    # the signs made on the device (no host copy, so the step can be captured in a CUDA graph):
    # sx = [1,1,1,1,-1,-1,-1,-1], sy = [1,-1,-1,1,1,-1,-1,1], sz = [1,1,-1,-1,1,1,-1,-1]
    i = torch.arange(8, device=box.device)
    one = torch.ones(8, dtype=box.dtype, device=box.device)
    sx = torch.where(i < 4, one, -one)
    sy = torch.where((i % 4 == 0) | (i % 4 == 3), one, -one)
    sz = torch.where(i % 4 < 2, one, -one)
    corners = torch.stack([l[:, None] / 2 * sx[None, :], w[:, None] / 2 * sy[None, :],
                           h[:, None] / 2 * sz[None, :]], dim=-1)  # (B, 8, 3) in box frame
    return apply_transform_points(corners, box, A=A)


def box_cloud(points: torch.Tensor, box: torch.Tensor, wlh: torch.Tensor, A=None) -> torch.Tensor:
    """BoxCloud (B, N, 9): distance from each point to the box center and its
    8 corners (points_utils.get_point_to_box_distance on the device)."""
    corners = box_corners(box, wlh, A=A)
    keypoints = torch.cat([box[:, None, :3], corners], dim=1)  # (B, 9, 3)
    diff = points[:, :, None, :] - keypoints[:, None, :, :]  # (B, N, 9, 3)
    return torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)


def points_in_box(points: torch.Tensor, box: torch.Tensor, wlh: torch.Tensor,
                  wlh_factor: float = 1.0, A=None, strict: bool = False) -> torch.Tensor:
    """In-box mask (B, N) for (B, N, 3) points and (B, 4) boxes: inclusive
    (<=) by default, as nuscenes points_in_box; strict (<) as
    get_in_box_mask's AABB comparison."""
    local = remove_transform_points(points, box, A=A)
    half = torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (wlh_factor / 2.0)
    a, h = local.abs(), half[:, None, :]
    return (a < h if strict else a <= h).all(dim=-1)


def limit_box_offset(offset: torch.Tensor, wlh: torch.Tensor, use_z: bool,
                     redraw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """getOffsetBB's limit_box rescue on the device (reference
    points_utils.py:70-76): an x/y offset above the box extent (positive
    overshoot only, as the reference compares the signed offset) is replaced
    by `redraw` (B, 2), or by 0.0 when redraw is None (limit_box_redraw
    'zero'); with use_z an overshooting z becomes 0.

    offset (B, 4) = (dx, dy, dz, dtheta) box-local; wlh (B, 3).
    """
    zero = torch.zeros_like(offset[:, 0])
    rx = zero if redraw is None else redraw[:, 0]
    ry = zero if redraw is None else redraw[:, 1]
    dx = torch.where(offset[:, 0] > wlh[:, 0], rx, offset[:, 0])
    dy = torch.where(offset[:, 1] > torch.clamp(wlh[:, 1], max=2.0), ry, offset[:, 1])
    dz = offset[:, 2]
    if use_z:
        dz = torch.where(dz > wlh[:, 2], zero, dz)
    return torch.stack([dx, dy, dz, offset[:, 3]], dim=-1)


def wrap_angle(t: torch.Tensor) -> torch.Tensor:
    """Wrap angles into (-pi, pi], as the host's quaternion angle extraction."""
    return np.pi - torch.remainder(np.pi - t, 2.0 * np.pi)


def transform_box_params(box: torch.Tensor, ref_box: torch.Tensor, A=None) -> torch.Tensor:
    """Express 4-DoF boxes (B, 4) in the frames of ref_box (B, 4): local
    center Rz(-t_ref) A^T (c - c_ref), local theta wrapped into (-pi, pi]."""
    local_c = remove_transform_points(box[:, None, :3], ref_box, A=A)[:, 0]
    local_t = wrap_angle(box[:, 3] - ref_box[:, 3])
    return torch.cat([local_c, local_t[:, None]], dim=-1)
