"""Plain pieces the references share: frozen copies of the port's host
padding and rigid box math, the strided resampler, a plain Dense / BatchNorm
layer over a state dict, and the tracking scores in float64 numpy.

Frozen copies, each from the file named at its head, in plain numpy or
PyTorch; nothing here imports the port or JAX. The float32 torch functions
repeat the port's operations in the port's order, so that a crop of the
same points around the same box keeps the same points on both sides (a
point on a crop's edge would otherwise fall in on one side and out on the
other, and the two steps would see different inputs).
"""

from __future__ import annotations

import math

import numpy as np
import torch

BN_EPS = 1e-5


def plain_precision():
    """float32 matmuls in float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_precision():
    """The control's precision: float32 matmuls in TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


# --- frozen copy of open3dsot_tpu_torch/tracking/scan_tracker.py:114-143 ---
def nearest(d: np.ndarray, P: int) -> np.ndarray:
    """The P smallest d, the lower index first among equal ones."""
    t = d[np.argpartition(d, P - 1)[P - 1]]
    if np.isnan(t):
        return np.argsort(d, kind="stable")[:P]
    below = np.flatnonzero(d < t)
    sel = np.concatenate([below, np.flatnonzero(d == t)[: P - len(below)]])
    return sel[np.lexsort((sel, d[sel]))]


def pad_frame(p: np.ndarray, P: int):
    """(N, 3) points -> (P, 3) padded + validity; above P points the P
    closest (L-inf) to the per-axis median."""
    p = np.asarray(p, np.float32).reshape(-1, 3)
    if len(p) > P:
        cols = np.ascontiguousarray(p.T)
        center = np.median(cols, axis=1)
        d = np.abs(cols[0] - center[0])
        for k in (1, 2):
            np.maximum(d, np.abs(cols[k] - center[k]), out=d)
        p = p[nearest(d, P)]
    out = np.zeros((P, 3), np.float32)
    valid = np.zeros((P,), bool)
    out[: len(p)] = p
    valid[: len(p)] = True
    return out, valid


# --- frozen copy of open3dsot_tpu_torch/geometry/rigid.py (z-up: A = None) ---
def rotz(t: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    rows = [torch.stack([c, -s, zeros], dim=-1), torch.stack([s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1)]
    return torch.stack(rows, dim=-2)


def rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """out[b, n, k] = sum_j points[b, n, j] * rot[b, k, j]."""
    return (points[:, :, None, :] * rot[:, None, :, :]).sum(dim=-1)


def remove_transform_points(points: torch.Tensor, ref_box: torch.Tensor) -> torch.Tensor:
    return rotate(points - ref_box[:, None, :3], rotz(-ref_box[:, 3]))


def apply_transform_points(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return rotate(points, rotz(box[:, 3])) + box[:, None, :3]


def get_offset_points(points, ref_box, offset_box):
    local = remove_transform_points(points, ref_box)
    local = rotate(local, rotz(offset_box[:, 3])) + offset_box[:, None, :3]
    return apply_transform_points(local, ref_box)


def get_offset_box(ref_box: torch.Tensor, offset_box: torch.Tensor) -> torch.Tensor:
    off = (rotz(ref_box[:, 3]) * offset_box[:, None, :3]).sum(dim=-1)
    new_angle = ref_box[:, 3] + offset_box[:, 3]
    return torch.cat([off + ref_box[:, :3], new_angle[:, None]], dim=-1)


def box_corners(box: torch.Tensor, wlh: torch.Tensor) -> torch.Tensor:
    w, l, h = wlh[:, 0], wlh[:, 1], wlh[:, 2]
    i = torch.arange(8, device=box.device)
    one = torch.ones(8, dtype=box.dtype, device=box.device)
    sx = torch.where(i < 4, one, -one)
    sy = torch.where((i % 4 == 0) | (i % 4 == 3), one, -one)
    sz = torch.where(i % 4 < 2, one, -one)
    corners = torch.stack([l[:, None] / 2 * sx[None, :], w[:, None] / 2 * sy[None, :],
                           h[:, None] / 2 * sz[None, :]], dim=-1)
    return apply_transform_points(corners, box)


def box_cloud(points: torch.Tensor, box: torch.Tensor, wlh: torch.Tensor) -> torch.Tensor:
    """(B, N, 9) distances from each point to the box centre and corners."""
    keypoints = torch.cat([box[:, None, :3], box_corners(box, wlh)], dim=1)
    diff = points[:, :, None, :] - keypoints[:, None, :, :]
    return torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)


def points_in_box(points, box, wlh, wlh_factor: float = 1.0) -> torch.Tensor:
    local = remove_transform_points(points, box)
    half = torch.stack([wlh[:, 1], wlh[:, 0], wlh[:, 2]], dim=-1) * (wlh_factor / 2.0)
    return (local.abs() <= half[:, None, :]).all(dim=-1)


# --- frozen copy of scan_tracker.py::_select_fixed, mode 'strided' ---
def select_strided(points: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """Exactly n rows of the valid subset: evenly spaced downsampling,
    cyclic upsampling; an all-invalid row gives zeros."""
    B, P, C = points.shape
    count = valid.sum(dim=1, keepdim=True, dtype=torch.int32)
    capped = count.clamp(1, P)
    ar = torch.arange(n, dtype=torch.int32, device=points.device)[None, :]
    vpos = torch.where(capped >= n, (ar * capped) // n, ar % capped)
    cs = torch.cumsum(valid, dim=1, dtype=torch.int32)
    idx = torch.searchsorted(cs, vpos, right=True).clamp(max=P - 1)
    out = torch.gather(points, 1, idx.long()[..., None].expand(B, n, C))
    return torch.where(count[..., None] > 0, out, 0.0)


# --- parameter lists, in the port's names and order ---
def dense_bn_specs(prefix, cin, cout):
    """(name, shape, init) of a Dense -> BatchNorm layer `prefix` (portbench/weights.py)."""
    return [(prefix + ".dense.weight", (cout, cin), ("w", cin)),
            (prefix + ".dense.bias", (cout,), ("b", cin)),
            (prefix + ".bn.weight", (cout,), ("gamma",)),
            (prefix + ".bn.bias", (cout,), ("beta",)),
            (prefix + ".bn.running_mean", (cout,), ("mean",)),
            (prefix + ".bn.running_var", (cout,), ("var",)),
            (prefix + ".bn.num_batches_tracked", (), ("count",))]


def dense_specs(prefix, cin, cout):
    """(name, shape, init) of a bare Dense `prefix`."""
    return [(prefix + ".weight", (cout, cin), ("w", cin)), (prefix + ".bias", (cout,), ("b", cin))]


def mlp_specs(prefix, cin, widths, final_plain=False):
    """(name, shape, init) of an MLP's layers `prefix`.layer{i}."""
    out, n = [], len(widths)
    for i, w in enumerate(widths):
        if final_plain and i == n - 1:
            out += dense_specs(f"{prefix}.layer{i}.dense", cin, w)
        else:
            out += dense_bn_specs(f"{prefix}.layer{i}", cin, w)
        cin = w
    return out



# --- plain layers over a state dict (unfolded BatchNorm, eval statistics) ---
def dense(x: torch.Tensor, sd: dict, prefix: str) -> torch.Tensor:
    return x @ sd[prefix + ".weight"].t() + sd[prefix + ".bias"]


def dense_bn_relu(x: torch.Tensor, sd: dict, prefix: str) -> torch.Tensor:
    """Dense -> eval BatchNorm -> ReLU, the layer `prefix` (`.dense`, `.bn`)."""
    x = dense(x, sd, prefix + ".dense")
    bn = prefix + ".bn"
    x = (x - sd[bn + ".running_mean"]) * torch.rsqrt(sd[bn + ".running_var"] + BN_EPS)
    return torch.relu(x * sd[bn + ".weight"] + sd[bn + ".bias"])


def mlp(x: torch.Tensor, sd: dict, prefix: str, n: int, final_plain: bool = False):
    """`prefix`.layer0 .. layer{n-1}; the last a bare Dense with final_plain."""
    for i in range(n):
        if final_plain and i == n - 1:
            x = dense(x, sd, f"{prefix}.layer{i}.dense")
        else:
            x = dense_bn_relu(x, sd, f"{prefix}.layer{i}")
    return x


# --- tracking scores, float64 numpy (the port's geometry/iou_device.py semantics) ---
def _quad(c, theta, wlh):
    """(4, 2) ground-plane footprint of a z-up box."""
    l, w = wlh[1], wlh[0]
    sx = np.array([1.0, 1.0, -1.0, -1.0]) * 0.5 * l
    sy = np.array([1.0, -1.0, -1.0, 1.0]) * 0.5 * w
    ct, st = math.cos(theta), math.sin(theta)
    return np.stack([c[0] + sx * ct - sy * st, c[1] + sx * st + sy * ct], axis=-1)


def _area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _ccw(q):
    x, y = q[:, 0], q[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return q if signed >= 0 else q[::-1]


def _clip(subject, clip):
    """Sutherland-Hodgman: the part of convex `subject` inside convex ccw `clip`."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        src, out = out, []
        if not src:
            break
        for j in range(len(src)):
            p, q = src[j], src[(j + 1) % len(src)]
            dp = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
            dq = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
            if dp >= 0:
                out.append(p)
            if (dp >= 0) != (dq >= 0):
                t = dp / (dp - dq)
                out.append(p + t * (q - p))
    return np.array(out).reshape(-1, 2)


def overlap_accuracy(a, wlh_a, b, wlh_b):
    """Volume IoU (the vertical span taken as [c_z - h, c_z], and the union
    of wlh products, as the reference's metric) and centre distance of two
    z-up boxes (cx, cy, cz, theta) in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    wlh_a, wlh_b = np.asarray(wlh_a, np.float64), np.asarray(wlh_b, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return 0.0, float("nan")
    qa, qb = _ccw(_quad(a[:3], a[3], wlh_a)), _ccw(_quad(b[:3], b[3], wlh_b))
    inter = _area(_clip(qa, qb))
    up = min(a[2], b[2]) - max(a[2] - wlh_a[2], b[2] - wlh_b[2])
    inter_vol = inter * max(up, 0.0)
    union = np.prod(wlh_a) + np.prod(wlh_b) - inter_vol
    iou = min(max(inter_vol / union if union != 0 else 0.0, 0.0), 1.0)
    return iou, float(np.linalg.norm(a[:3] - b[:3]))


def ulp32(x) -> np.ndarray:
    """The float32 unit in the last place at |x|, |x| taken as at least 1."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(np.asarray(x, np.float64)), 1.0))) - 23)


def ulp_gap(got, want, angle: bool = False) -> np.ndarray:
    """|got - want| (the short way round for angles) in float32 units in the
    last place of the larger of the two: a box composed onto a carried box
    is rounded at the carried box's magnitude, which grows along a track, so
    a gap in metres or radians would read larger on longer tracks for the
    same rounding."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = wrapped_gap(got, want) if angle else np.abs(got - want)
    return d / ulp32(np.maximum(np.abs(got), np.abs(want)))


def wrapped_gap(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """|x - y| of angles, taken the short way round."""
    d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def wrap_angle(t: torch.Tensor) -> torch.Tensor:
    """Angles into (-pi, pi] (frozen copy of rigid.py::wrap_angle)."""
    return np.pi - torch.remainder(np.pi - t, 2.0 * np.pi)


def transform_box_params(box: torch.Tensor, ref_box: torch.Tensor) -> torch.Tensor:
    """4-DoF boxes (B, 4) in the frames of ref_box (B, 4) (frozen copy of
    rigid.py::transform_box_params, z-up)."""
    local_c = remove_transform_points(box[:, None, :3], ref_box)[:, 0]
    return torch.cat([local_c, wrap_angle(box[:, 3] - ref_box[:, 3])[:, None]], dim=-1)
