"""Batched tracking metrics on tensors (rotated-box IoU + center accuracy),
port of `open3dsot_tpu/geometry/iou_device.py`.

The twin of the host metrics (geometry/iou.py, the reference's
estimateOverlap/estimateAccuracy) for the scan tracker: its (B, T) boxes
are scored on the device, so dataset evaluation fetches two (B, T) arrays
instead of clipping polygons on the host per frame. Every (prediction, gt)
pair is clipped by Sutherland-Hodgman at once: the JAX package vmaps a
per-pair clip, here the pairs are the leading axis of (pairs, 8 vertices)
tensors and each polygon carries its vertex count.

Boxes are the scan tracker's device form: params (..., 4) = (cx, cy, cz,
theta) with world rotation A @ Rz(theta) (geometry/rigid.py), wlh (..., 3).
The ground-plane footprint drops the up component of the center and turns
the (l/2, w/2) rectangle by theta in the remaining plane, for both bases.

Reference quirks kept exactly:
  * volume IoU measures the vertical span as [c_up - h, c_up];
  * dim = 2 accuracy is the distance in the up component only;
  * the dim = 2 union adds the polygon areas, the dim = 3 union the wlh
    products;
  * a non-finite box scores IoU 0.
"""

from __future__ import annotations

import numpy as np
import torch

_V = 8  # max vertices of (4-gon ∩ 4-gon)


def up_index(up_axis) -> int:
    """Index of the up component for a config's up_axis."""
    nz = np.nonzero(np.asarray(up_axis, dtype=np.float64))[0]
    if len(nz) != 1:
        raise ValueError(f"unsupported up_axis {up_axis!r}")
    return int(nz[0])


def bev_quad(params: torch.Tensor, wlh: torch.Tensor, up_idx: int) -> torch.Tensor:
    """(..., 4) params, (..., 3) wlh -> (..., 4, 2) footprint quad."""
    theta = params[..., 3]
    hl, hw = 0.5 * wlh[..., 1, None], 0.5 * wlh[..., 0, None]
    # the corners' signs as scalars: a tensor of them made on the host would
    # be a blocking copy to the card. A product by -1.0 keeps a NaN's bits,
    # where a negation would flip its sign.
    lx = torch.cat([hl, hl, hl * -1.0, hl * -1.0], dim=-1)
    ly = torch.cat([hw, hw * -1.0, hw * -1.0, hw], dim=-1)
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    u = lx * ct - ly * st
    v = lx * st + ly * ct
    plane = [i for i in range(3) if i != up_idx]
    return torch.stack([params[..., plane[0], None] + u, params[..., plane[1], None] + v], dim=-1)


def _ccw(poly: torch.Tensor) -> torch.Tensor:
    """Orient (M, 4, 2) quads counter-clockwise (host iou.py::_ccw)."""
    x, y = poly[..., 0], poly[..., 1]
    signed = 0.5 * ((x * y.roll(-1, dims=-1)).sum(-1) - (y * x.roll(-1, dims=-1)).sum(-1))
    return torch.where((signed >= 0)[:, None, None], poly, poly.flip(-2))


def _next(n: torch.Tensor) -> torch.Tensor:
    """(M, V) index of each vertex's successor in polygons of n (M,) vertices."""
    idx = torch.arange(_V, device=n.device)
    return torch.where(idx + 1 < n[:, None], idx + 1, 0)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (M, V[, 2]) rows picked by idx (M, K)."""
    if a.dim() == 2:
        return torch.gather(a, 1, idx)
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def _masked_area(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first n (M,) vertices of poly (M, V, 2)."""
    idx = torch.arange(_V, device=n.device)
    nxt = _next(n)
    x, y = poly[..., 0], poly[..., 1]
    contrib = x * _take(y, nxt) - _take(x, nxt) * y
    contrib = torch.where(idx < n[:, None], contrib, 0.0)
    return 0.5 * contrib.sum(-1).abs()


def _clip_once(poly: torch.Tensor, n: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Clip (poly (M, V, 2), n (M,)) by the half-planes left of the directed
    edges a -> b (M, 2)."""
    edge = b - a
    rel = poly - a[:, None, :]
    d = edge[:, 0, None] * rel[..., 1] - edge[:, 1, None] * rel[..., 0]  # (M, V)
    valid = torch.arange(_V, device=n.device) < n[:, None]
    nxt = _next(n)
    dc, dn = d, _take(d, nxt)
    cur, nxt_p = poly, _take(poly, nxt)
    denom = dc - dn
    t = torch.where(denom != 0, dc / torch.where(denom != 0, denom, 1.0), 0.0)
    inter = cur + t[..., None] * (nxt_p - cur)
    keep_cur = valid & (dc >= 0)
    keep_int = valid & ((dc >= 0) != (dn >= 0))
    # emission order per vertex: cur then intersection (host _clip_polygon)
    M = poly.shape[0]
    cands = torch.stack([cur, inter], dim=2).reshape(M, 2 * _V, 2)
    flags = torch.stack([keep_cur, keep_int], dim=2).reshape(M, 2 * _V)
    order = torch.argsort((~flags).to(torch.int8), dim=1, stable=True)  # keeps emission order
    new_poly = _take(cands, order[:, :_V])
    new_n = flags.sum(-1).clamp(max=_V)
    return new_poly, new_n


def _pair_intersection_area(quad_a: torch.Tensor, quad_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas (M,) of two (M, 4, 2) sets of convex quads."""
    subject, clip = _ccw(quad_a), _ccw(quad_b)
    M = subject.shape[0]
    poly = torch.cat([subject, subject.new_zeros(M, _V - 4, 2)], dim=1)
    n = torch.full((M,), 4, dtype=torch.int64, device=subject.device)
    for i in range(4):
        poly, n = _clip_once(poly, n, clip[:, i], clip[:, (i + 1) % 4])
    return _masked_area(poly, n)


def _poly_area(q: torch.Tensor) -> torch.Tensor:
    return 0.5 * (q[..., :, 0] * q[..., :, 1].roll(-1, dims=-1)
                  - q[..., :, 0].roll(-1, dims=-1) * q[..., :, 1]).sum(-1).abs()


def overlap_accuracy(params_a, wlh_a, params_b, wlh_b, *, dim: int, up_idx: int):
    """Batched estimateOverlap + estimateAccuracy (reference metrics.py:27-72).

    params_* (..., 4), wlh_* (..., 3); returns (iou (...), dist (...)) f32.
    dim=2 -> BEV IoU and up-component distance; dim=3 -> volume IoU (with
    the reference's vertical-extent quirk) and 3D center distance.
    """
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    params_a, params_b = params_a.float(), params_b.float()
    wlh_a, wlh_b = wlh_a.float(), wlh_b.float()
    quad_a = bev_quad(params_a, wlh_a, up_idx)
    quad_b = bev_quad(params_b, wlh_b, up_idx)
    inter = _pair_intersection_area(quad_a.reshape(-1, 4, 2), quad_b.reshape(-1, 4, 2))
    inter = inter.reshape(params_a.shape[:-1])

    ca, cb = params_a[..., :3], params_b[..., :3]
    if dim == 2:
        # the host union adds the POLYGON areas, so identical quads cancel exactly
        union = _poly_area(quad_a) + _poly_area(quad_b) - inter
        iou = torch.where(union > 0,
                          torch.clamp(inter / torch.where(union > 0, union, 1.0), max=1.0), 0.0)
        dist = (ca[..., up_idx] - cb[..., up_idx]).abs()
    else:
        up_a, up_b = ca[..., up_idx], cb[..., up_idx]
        h_a, h_b = wlh_a[..., 2], wlh_b[..., 2]
        up_max = torch.minimum(up_a, up_b)
        up_min = torch.maximum(up_a - h_a, up_b - h_b)
        inter_vol = inter * torch.clamp(up_max - up_min, min=0.0)
        # host volumes are wlh PRODUCTS, not polygon areas
        vol_a = wlh_a[..., 0] * wlh_a[..., 1] * h_a
        vol_b = wlh_b[..., 0] * wlh_b[..., 1] * h_b
        union = vol_a + vol_b - inter_vol
        iou = torch.where(union != 0, inter_vol / torch.where(union != 0, union, 1.0), 0.0)
        iou = torch.clamp(iou, 0.0, 1.0)
        dist = torch.linalg.vector_norm(ca - cb, dim=-1)

    finite = torch.isfinite(params_a).all(-1) & torch.isfinite(params_b).all(-1)
    iou = torch.where(finite, torch.where(torch.isfinite(iou), iou, 0.0), 0.0)
    return iou, dist
