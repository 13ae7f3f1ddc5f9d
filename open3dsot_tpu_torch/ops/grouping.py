"""Index gather/group ops, port of `open3dsot_tpu/ops/grouping.py`.

Channels-last (B, N, C) features, as in the JAX package; both are
`torch.gather` along the point axis.
"""

from __future__ import annotations

import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, S) indices -> (B, S, C)."""
    C = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, C))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, S, K) indices -> (B, S, K, C)."""
    B, S, K = idx.shape
    return gather_points(features, idx.reshape(B, S * K)).reshape(B, S, K, features.shape[-1])
