"""3-NN feature interpolation, port of `open3dsot_tpu/ops/interpolate.py`
(the reference's CUDA `three_nn` / `three_interpolate`,
pointnet2_utils.py:105-191), consumed by models/pointnet.py::
FeaturePropagation.

Dense over the (B, n, m) distance matrix, as the JAX package computes it:
the three nearest by `pairwise_sqdist`, equal distances keeping the lower
index first (a stable sort, as `lax.top_k` orders ties), then a gather and
a weighted sum. The gradient is autograd's, as JAX's is autodiff: the
weighted scatter-add that the CUDA extension hand-codes.
"""

from __future__ import annotations

import torch

from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.neighbors import pairwise_sqdist


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(B, n, 3) unknown, (B, m, 3) known -> (dists (B, n, 3), idx (B, n, 3)
    int32): the euclidean (sqrt) distances of the three nearest known points,
    ascending, and their indices (no gradient)."""
    d2, idx = torch.sort(pairwise_sqdist(unknown, known), dim=-1, stable=True)
    return torch.sqrt(d2[..., :3].clamp_min(0.0)), idx[..., :3].int()


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(B, m, C) features, (B, n, 3) idx, (B, n, 3) weight -> (B, n, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(dim=2)
