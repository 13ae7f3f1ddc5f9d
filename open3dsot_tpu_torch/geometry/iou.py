"""Shapely-free rotated-box overlap (Sutherland–Hodgman convex clipping).

Replaces the reference's shapely polygon intersection
(/root/reference/utils/metrics.py:36-72) with a direct convex-polygon clip in
numpy. The 3D ("volume") branch reproduces the reference's exact vertical
extent formula — including its quirk of measuring the vertical span as
[center_up - height, center_up] — because the published Success numbers
depend on it (metrics.py:62-70).
"""

from __future__ import annotations

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon (ccw positive, abs returned)."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip polygon by the half-plane left of directed edge a->b."""
    if len(subject) == 0:
        return subject
    edge = b - a
    # signed 2D cross product: >0 means left of (inside for a ccw clip polygon)
    rel = subject - a
    d = edge[0] * rel[:, 1] - edge[1] * rel[:, 0]
    out = []
    n = len(subject)
    for i in range(n):
        cur, nxt = subject[i], subject[(i + 1) % n]
        dc, dn = d[i], d[(i + 1) % n]
        if dc >= 0:
            out.append(cur)
            if dn < 0:
                t = dc / (dc - dn)
                out.append(cur + t * (nxt - cur))
        elif dn >= 0:
            t = dc / (dc - dn)
            out.append(cur + t * (nxt - cur))
    return np.array(out) if out else np.zeros((0, 2))


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return poly if signed >= 0 else poly[::-1]


def convex_intersection_area(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    """Intersection area of two convex polygons, (Na, 2) and (Nb, 2)."""
    poly_a, poly_b = _ccw(np.asarray(poly_a, float)), _ccw(np.asarray(poly_b, float))
    clipped = poly_a
    nb = len(poly_b)
    for i in range(nb):
        clipped = _clip_polygon(clipped, poly_b[i], poly_b[(i + 1) % nb])
        if len(clipped) == 0:
            return 0.0
    return polygon_area(clipped)


def box_to_poly(box, up_axis=(0, -1, 0)) -> np.ndarray:
    """Project box corners to the ground plane as a convex quad (4, 2).

    Matches reference fromBoxToPoly (metrics.py:36-46): y-up (camera coords)
    takes corners [[0,2]] rows at columns [0, 1, 5, 4]; z-up takes
    bottom_corners.
    """
    if up_axis[1] != 0:
        return box.corners()[[0, 2]].T[[0, 1, 5, 4]]
    elif up_axis[2] != 0:
        # bottom corners are 3D; shapely ignores the constant z — project to xy
        return box.bottom_corners().T[:, :2]
    raise ValueError(f"unsupported up_axis {up_axis}")


def estimateAccuracy(box_a, box_b, dim=3, up_axis=(0, -1, 0)) -> float:
    """Center distance, 3D or projected (reference metrics.py:27-33)."""
    if dim == 3:
        return float(np.linalg.norm(box_a.center - box_b.center, ord=2))
    elif dim == 2:
        up_axis = np.array(up_axis)
        return float(
            np.linalg.norm(box_a.center[up_axis != 0] - box_b.center[up_axis != 0], ord=2)
        )
    raise ValueError(f"dim must be 2 or 3, got {dim}")


def estimateOverlap(box_a, box_b, dim=2, up_axis=(0, -1, 0)) -> float:
    """BEV or volume IoU (reference metrics.py:49-72).

    Non-finite box parameters (a diverged tracker) score 0, mirroring the
    reference's except-ValueError->0 behavior with shapely.
    """
    if not (np.all(np.isfinite(box_a.center)) and np.all(np.isfinite(box_b.center))):
        return 0.0
    try:
        poly_a = box_to_poly(box_a, up_axis)
        poly_b = box_to_poly(box_b, up_axis)
        inter_area = convex_intersection_area(poly_a, poly_b)
        area_a = polygon_area(poly_a)
        area_b = polygon_area(poly_b)
        union_area = area_a + area_b - inter_area
        if dim == 2:
            if union_area <= 0 or not np.isfinite(union_area):
                return 0.0
            # fp wobble in the polygon clip can land an epsilon above 1
            return float(min(inter_area / union_area, 1.0))
        up = np.array(up_axis)
        up_max = min(box_a.center[up != 0][0], box_b.center[up != 0][0])
        up_min = max(
            box_a.center[up != 0][0] - box_a.wlh[2],
            box_b.center[up != 0][0] - box_b.wlh[2],
        )
        inter_vol = inter_area * max(0.0, up_max - up_min)
        anno_vol = box_a.wlh[0] * box_a.wlh[1] * box_a.wlh[2]
        subm_vol = box_b.wlh[0] * box_b.wlh[1] * box_b.wlh[2]
        overlap = inter_vol * 1.0 / (anno_vol + subm_vol - inter_vol)
        if not np.isfinite(overlap):
            return 0.0
        return float(min(max(overlap, 0.0), 1.0))
    except (ValueError, ZeroDivisionError):
        return 0.0
