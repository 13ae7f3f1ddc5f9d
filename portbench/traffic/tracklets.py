"""The benchmark's one generator of tracking traffic: rigid-box tracklets in
clutter, from a mix's parameters and a seed.

Rewritten from the port's synthetic dataset
(`open3dsot_tpu_torch/data/synthetic.py::_make_frame`, itself the JAX
package's): a box of a car's size moves with a constant velocity and yaw
rate; each frame holds points on the box's surface and clutter around it.
Four things differ from that generator:

- the tracklet lengths are a fixed multiset, the same for every seed
  (`lengths` of the mix); the seed only assigns them to tracklets, so every seed asks
  for the same work;
- each frame carries a number of points drawn from `points` (both ends
  included), of which a share drawn from `object_share` lies on the box;
- the clutter fills an ROI around the object (`clutter_half`, metres), as
  a dataset with its limit box crops a sweep around the object;
- the object's points lie on the surface of a box 2% smaller than the
  object's, so that every one of them is inside the ground-truth box (a
  training sampler redraws, from numpy's global state, a frame with ten
  target points or fewer).

Everything is numpy; nothing of the port is imported. A tracklet is a dict
of raw arrays: `points` (a list of (N_t, 3) float32), `center` (T, 3) and
`theta` (T,) float64 about +z, `wlh` (3,) float64.
"""

from __future__ import annotations

import numpy as np


def length_multiset(n: int, knots) -> np.ndarray:
    """n tracklet lengths, the (i + 0.5) / n quantiles of a distribution
    given by `knots` [[quantile, length], ...] (log-linear between them).
    The same n and knots give the same multiset, whatever the seed."""
    q = np.array([k[0] for k in knots], np.float64)
    log_len = np.log(np.array([k[1] for k in knots], np.float64))
    u = (np.arange(n) + 0.5) / n
    return np.rint(np.exp(np.interp(u, q, log_len))).astype(np.int64)


INSET = 0.98  # object points on the surface of a box this much smaller than the object's


def _frame(rng, n_points: int, n_obj: int, center, theta: float, wlh, clutter_half):
    """(n_points, 3) float32: n_obj points on the (inset) box surface, the
    rest clutter."""
    w, l, h = np.asarray(wlh) * INSET
    local = rng.uniform(-0.5, 0.5, size=(3, n_obj)) * np.array([[l], [w], [h]])
    face = rng.integers(0, 3, size=n_obj)
    sign = rng.choice([-0.5, 0.5], size=n_obj)
    local[0, face == 0] = sign[face == 0] * l
    local[1, face == 1] = sign[face == 1] * w
    local[2, face == 2] = sign[face == 2] * h
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    obj = rot @ local + np.asarray(center).reshape(3, 1)
    n_bg = n_points - n_obj
    bg = rng.uniform(-1.0, 1.0, size=(3, n_bg)) * np.asarray(clutter_half).reshape(3, 1)
    bg += np.asarray(center).reshape(3, 1)
    pts = np.concatenate([obj, bg], axis=1).T.astype(np.float32)
    return pts[rng.permutation(n_points)]


def generate(mix: dict, seed: int, n: int = None) -> list:
    """The mix's tracklets for `seed` (n of them, default the mix's
    `tracklets`)."""
    n = int(mix["tracklets"] if n is None else n)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 21])
    lengths = rng.permutation(length_multiset(n, mix["lengths"]))
    lo, hi = mix["points"]
    s_lo, s_hi = mix["object_share"]
    half = mix["clutter_half"]
    out = []
    for T in lengths:
        wlh = rng.uniform([1.5, 3.2, 1.4], [2.0, 4.5, 1.8])
        c0 = rng.uniform([-8.0, -8.0, -1.0], [8.0, 8.0, 0.5])
        theta0 = rng.uniform(-np.pi, np.pi)
        vel = np.append(rng.uniform(-0.5, 0.5, size=2), 0.0)
        dtheta = rng.uniform(-0.05, 0.05)
        t = np.arange(T)
        center = c0[None, :] + vel[None, :] * t[:, None]
        theta = theta0 + dtheta * t
        sizes = rng.integers(lo, hi + 1, size=T)
        shares = rng.uniform(s_lo, s_hi, size=T)
        points = [_frame(rng, int(sizes[i]), max(1, int(shares[i] * sizes[i])), center[i],
                         float(theta[i]), wlh, half) for i in range(T)]
        out.append({"points": points, "center": center, "theta": theta, "wlh": wlh})
    return out
