"""Slow numpy reference implementations of the pointnet2 op suite, copy of
`open3dsot_tpu/ops/reference.py`.

These replicate, step by step, the semantics of the CUDA kernels the
reference consumes (erikwijmans/Pointnet2_PyTorch `pointnet2_ops`, wrapped at
the reference's pointnet2/utils/pointnet2_utils.py). They are golden models
for the tests: the port computes with its kernels and their plain PyTorch
versions (ops/sampling.py, ops/neighbors.py, ops/interpolate.py).
"""

from __future__ import annotations

import numpy as np


def fps_ref(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """(B, N, 3) -> (B, npoint) indices, CUDA furthest_point_sampling semantics."""
    B, N, _ = xyz.shape
    out = np.zeros((B, npoint), dtype=np.int32)
    for b in range(B):
        dist = np.full(N, 1e10, dtype=np.float64)
        last = 0
        for j in range(1, npoint):
            d2 = np.sum((xyz[b] - xyz[b, last]) ** 2, axis=-1)
            dist = np.minimum(dist, d2)
            last = int(np.argmax(dist))
            out[b, j] = last
    return out


def ball_query_ref(radius: float, nsample: int, xyz: np.ndarray, new_xyz: np.ndarray) -> np.ndarray:
    """(B, N, 3), (B, S, 3) -> (B, S, nsample), CUDA ball_query semantics:
    first nsample strictly-in-radius indices in ascending order, padded with
    the first found index (0 if none)."""
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    out = np.zeros((B, S, nsample), dtype=np.int32)
    r2 = radius * radius
    for b in range(B):
        for s in range(S):
            cnt = 0
            for n in range(N):
                d2 = np.sum((xyz[b, n] - new_xyz[b, s]) ** 2)
                if d2 < r2:
                    if cnt == 0:
                        out[b, s, :] = n
                    out[b, s, cnt] = n
                    cnt += 1
                    if cnt >= nsample:
                        break
    return out


def knn_ref(query: np.ndarray, ref: np.ndarray, k: int) -> np.ndarray:
    d2 = np.sum((query[:, :, None, :] - ref[:, None, :, :]) ** 2, axis=-1)
    return np.argsort(d2, axis=-1, kind="stable")[:, :, :k].astype(np.int32)


def three_nn_ref(unknown: np.ndarray, known: np.ndarray):
    d2 = np.sum((unknown[:, :, None, :] - known[:, None, :, :]) ** 2, axis=-1)
    idx = np.argsort(d2, axis=-1, kind="stable")[:, :, :3].astype(np.int32)
    dist = np.sqrt(np.take_along_axis(d2, idx, axis=-1))
    return dist, idx
