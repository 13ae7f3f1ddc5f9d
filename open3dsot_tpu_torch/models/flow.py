"""FlowNet3D-style layers, port of `open3dsot_tpu/models/flow.py` (the
reference's FlowEmbedding and PointNetSetUpConv, pointnet2_modules.py:
215-334). Like the reference's and JAX's, they complete the layer library:
none of the three trackers uses them. Plain PyTorch, channels-last, the
module names flax's (`mlp`, `mlp1`, `mlp2`), so that weights.py maps JAX
variables onto them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.neighbors import ball_query, knn


def _neighbours(use_knn: bool, radius: float, nsample: int, xyz1: torch.Tensor,
                xyz2: torch.Tensor) -> torch.Tensor:
    """For each point of cloud 1, the indices (B, N1, nsample) of its
    neighbours in cloud 2: its nsample nearest, or a ball query."""
    if use_knn:
        return knn(xyz1.detach(), xyz2.detach(), nsample)
    return ball_query(radius, nsample, xyz2.detach(), xyz1.detach())


class FlowEmbedding(nn.Module):
    """Cross-cloud correlation: for each point of cloud 1, its neighbours in
    cloud 2, [pos_diff || feat2 || feat1] -> MLP -> max over the neighbours.
    `in_channel` is the width of each cloud's features (the MLP takes
    2 * in_channel + 3, as the reference's)."""

    def __init__(self, radius: float, nsample: int, in_channel: int, mlp: Sequence[int],
                 use_knn: bool = True, device=None):
        super().__init__()
        self.radius, self.nsample, self.use_knn = radius, nsample, use_knn
        self.mlp = MLP(2 * in_channel + 3, mlp, device=device)

    def forward(self, xyz1, xyz2, feature1, feature2):
        """xyz1 / xyz2 (B, N, 3), feature1 / feature2 (B, N, C) -> (xyz1,
        new_feature (B, N1, mlp[-1]))."""
        idx = _neighbours(self.use_knn, self.radius, self.nsample, xyz1, xyz2)
        pos_diff = group_points(xyz2, idx) - xyz1[:, :, None, :]
        feat2 = group_points(feature2, idx)  # (B, N1, K, C)
        feat1 = feature1[:, :, None, :].expand(*feat2.shape[:3], feature1.shape[-1])
        feat = self.mlp(torch.cat([pos_diff, feat2, feat1], dim=-1))
        return xyz1, feat.amax(dim=2)


class PointNetSetUpConv(nn.Module):
    """Features of a sparse cloud 2 propagated to a dense cloud 1: each
    point's neighbours in cloud 2, [feat2 || pos_diff] -> `mlp1` -> max over
    the neighbours, || feature1 -> `mlp2` (either MLP may be empty).
    `f1_channel` / `f2_channel` are the clouds' feature widths."""

    def __init__(self, nsample: int, radius: float, f1_channel: int, f2_channel: int,
                 mlp: Sequence[int], mlp2: Sequence[int], use_knn: bool = True, device=None):
        super().__init__()
        self.radius, self.nsample, self.use_knn = radius, nsample, use_knn
        width = f2_channel + 3
        self.mlp1 = MLP(width, mlp, device=device) if len(mlp) else None
        width = (mlp[-1] if len(mlp) else width) + f1_channel
        self.mlp2 = MLP(width, mlp2, device=device) if len(mlp2) else None

    def forward(self, xyz1, xyz2, feature1: Optional[torch.Tensor], feature2) -> torch.Tensor:
        """xyz1 (B, N1, 3) dense, xyz2 (B, N2, 3) sparse, feature1 (B, N1, C1)
        or None, feature2 (B, N2, C2) -> (B, N1, out)."""
        idx = _neighbours(self.use_knn, self.radius, self.nsample, xyz1, xyz2)
        pos_diff = group_points(xyz2, idx) - xyz1[:, :, None, :]
        feat = torch.cat([group_points(feature2, idx), pos_diff], dim=-1)
        if self.mlp1 is not None:
            feat = self.mlp1(feat)
        feat = feat.amax(dim=2)
        if feature1 is not None:
            feat = torch.cat([feat, feature1], dim=-1)
        if self.mlp2 is not None:
            feat = self.mlp2(feat)
        return feat
