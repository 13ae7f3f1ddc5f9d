"""Template-search cross-correlation heads, port of `open3dsot_tpu/models/xcorr.py`.

- `P2BXCorr`: dense cosine similarity (B, M, N), augmented with the
  broadcast template xyz and features, shared MLP over the grid, max over
  the template axis (reference head/xcorr.py:20-53).
- `BoxAwareXCorr`: k nearest template points per search point in BoxCloud
  space, their xyz | BoxCloud | feature, shared MLP, max over k
  (head/xcorr.py:56-103).

Plain PyTorch: the JAX package has no Pallas kernel here. `dtype` is the
compute dtype of their MLPs (JAX xcorr.py:55-101); the similarity, kNN and
grouping stay f32 (torch.cat promotes bf16 features beside f32 xyz, as jnp).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.neighbors import knn


class P2BXCorr(nn.Module):
    def __init__(self, feature_channel: int, hidden_channel: int, out_channel: int, device=None,
                 dtype=None):
        super().__init__()
        h = hidden_channel
        self.mlp = MLP(4 + feature_channel, [h, h, h], device=device, dtype=dtype)
        self.fea_layer = MLP(h, [h, out_channel], final_plain=True, device=device, dtype=dtype)

    def forward(self, template_feature, search_feature, template_xyz):
        """(B, M, f), (B, N, f), (B, M, 3) -> (B, N, out_channel)."""
        B, M, f = template_feature.shape
        N = search_feature.shape[1]
        t_norm = template_feature / (template_feature.norm(dim=-1, keepdim=True) + 1e-8)
        s_norm = search_feature / (search_feature.norm(dim=-1, keepdim=True) + 1e-8)
        sim = torch.matmul(t_norm, s_norm.transpose(1, 2))  # (B, M, N)
        fusion = torch.cat([sim[..., None],
                            template_xyz[:, :, None, :].expand(B, M, N, 3),
                            template_feature[:, :, None, :].expand(B, M, N, f)], dim=-1)
        fusion = self.mlp(fusion).amax(dim=1)  # max over the template -> (B, N, h)
        return self.fea_layer(fusion)


class BoxAwareXCorr(nn.Module):
    def __init__(self, feature_channel: int, hidden_channel: int, out_channel: int, k: int = 4,
                 bc_channel: int = 9, use_search_bc: bool = False,
                 use_search_feature: bool = False, device=None, dtype=None):
        super().__init__()
        self.k = k
        self.use_search_bc, self.use_search_feature = use_search_bc, use_search_feature
        c_in = 3 + bc_channel + feature_channel
        c_in += bc_channel if use_search_bc else 0
        c_in += feature_channel if use_search_feature else 0
        h = hidden_channel
        self.mlp = MLP(c_in, [h, h, h], device=device, dtype=dtype)
        self.fea_layer = MLP(h, [h, out_channel], final_plain=True, device=device, dtype=dtype)

    def forward(self, template_feature, search_feature, template_xyz, search_xyz,
                template_bc, search_bc):
        """(B, M, f), (B, N, f), (B, M, 3), (B, N, 3), (B, M, 9), (B, N, 9)
        -> (B, N, out_channel)."""
        idx = knn(search_bc, template_bc, self.k)  # (B, N, k)
        template_xfb = torch.cat([template_xyz, template_bc, template_feature], dim=-1)
        corr = group_points(template_xfb, idx)  # (B, N, k, 3 + 9 + f)
        lead = corr.shape[:3]
        if self.use_search_bc:
            corr = torch.cat([search_bc[:, :, None, :].expand(*lead, search_bc.shape[-1]), corr],
                             dim=-1)
        if self.use_search_feature:
            corr = torch.cat([search_feature[:, :, None, :].expand(*lead, search_feature.shape[-1]),
                              corr], dim=-1)
        fusion = self.mlp(corr).amax(dim=2)  # max over k -> (B, N, h)
        return self.fea_layer(fusion)
