"""Neighborhood queries (ball query, kNN), port of `open3dsot_tpu/ops/neighbors.py`.

Dense over the (B, M, N) distance matrix, as the JAX package builds them.
Two forms of the squared distance, each for a reason:

- `pairwise_sqdist` is the JAX expanded form a^2 + b^2 - 2ab, clamped at
  0; `knn` ranks by it (BoxAwareXCorr's BoxCloud neighbors).
- `sqdist_direct` is ((dx*dx) + (dy*dy)) + (dz*dz) of direct differences,
  one rounded op at a time in that order: the order that the fused SA
  kernel K4 (csrc/sa_fused.cu), the JAX one (`sa_fused.py::_sa_bq_kernel`)
  and the original CUDA op use. `ball_query` takes it, so the plain SA
  path, `sa_eval_plain` and K4 select the same neighbors even for a point
  at d^2 within rounding of r^2; the expanded form can place such a point
  on the other side of the radius.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, D), (B, N, D) -> (B, M, N) squared euclidean distances."""
    a2 = (a * a).sum(-1, keepdim=True)  # (B, M, 1)
    b2 = (b * b).sum(-1, keepdim=True)  # (B, N, 1)
    cross = torch.matmul(a, b.transpose(1, 2))
    return (a2 + b2.transpose(1, 2) - 2.0 * cross).clamp_min(0.0)


def sqdist_direct(centers: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, 3), (B, N, 3) -> (B, S, N): ((dx*dx) + (dy*dy)) + (dz*dz)."""
    d = [centers[:, :, None, c] - xyz[:, None, :, c] for c in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def radius_sq(radius: float) -> float:
    """r^2 taken in double and rounded once to f32, as JAX's weak-typed float."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points, (B, S, 3) centers -> (B, S, nsample) int32 indices.

    CUDA semantics: for each center, the first `nsample` points with squared
    distance strictly < radius^2, in ascending index order; unfilled slots
    repeat the first in-radius index; a center with no in-radius point gets
    all zeros (unreachable where centers are among the points).
    """
    N = xyz.shape[1]
    d2 = sqdist_direct(new_xyz.float(), xyz.float())
    r2 = torch.tensor(radius_sq(radius), dtype=torch.float32, device=xyz.device)
    iota = torch.arange(N, device=xyz.device)
    key = torch.where(d2 < r2, iota, N)  # in-radius points keep their index
    if nsample > N:
        key = F.pad(key, (0, nsample - N), value=N)
    key = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    valid = key < N
    first = torch.where(valid[..., :1], key[..., :1], 0)
    return torch.where(valid, key, first).int()


def knn(query: torch.Tensor, ref: torch.Tensor, k: int) -> torch.Tensor:
    """k nearest refs per query point: (B, M, D), (B, N, D) -> (B, M, k) int32.

    Distance-ascending; equal distances keep the lowest index first, as
    `lax.top_k` does (a stable sort: torch.topk gives no such order).
    """
    d2 = pairwise_sqdist(query, ref)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k].int()
