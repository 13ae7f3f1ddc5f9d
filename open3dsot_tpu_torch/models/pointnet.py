"""PointNet encoders, port of `open3dsot_tpu/models/pointnet.py`:
MiniPointNet and SegPointNet of M2-Track (reference
models/backbone/pointnet.py:91-204), SetAbstraction and PointnetBackbone of
BAT/P2B (pointnet2_modules.py:24-149, pointnet.py:12-88).

With `fused_eval` (the default) the eval forward goes through the kernels:
K1/K2 (ops/chain_fused.py) for the M2 encoders, K3 (ops/sampling.py) and
K4 (ops/sa_fused.py) for the SA layers. `fused_eval=False` is the plain
PyTorch forward that the kernels are held against: the layer stack with
BatchNorm unfolded, and for SA the plain FPS, ball query and grouping. The
folded weights are cached and folded again whenever a parameter or buffer
changes: a load_state_dict (in-place copy, bumping the tensor version), a
.to() (new storage) or a training step (optimizer and running-statistics
updates are in place).

In training mode (`.train()`) an SA layer takes K6 (ops/sa_fused_train.py)
when `fused_train` is set, it has point features and a 3-layer MLP, as the
JAX package selects it (pointnet.py:192-216); every other SA layer (the
featureless first one, the RPN's vote layer) runs the plain grid MLP with
training BatchNorm under autograd, and `amax` over the K neighbours, whose
gradient is split over ties as JAX's. FPS stays K3 when `fused_eval` is
set; the M2 encoders have no training form here yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.ops.chain_fused import (
    FoldedChain,
    fused_pointnet_encoder,
    fused_seg_head,
)
from open3dsot_tpu_torch.ops.grouping import gather_points
from open3dsot_tpu_torch.ops.neighbors import ball_query
from open3dsot_tpu_torch.ops.sa_fused import fused_sa_apply, group_inputs
from open3dsot_tpu_torch.ops.sa_fused_train import fused_sa_train_apply
from open3dsot_tpu_torch.ops.sampling import furthest_point_sample, furthest_point_sample_plain


class _FoldCache(nn.Module):
    """Caches `self._fold()` until a parameter or buffer changes."""

    def _weights_key(self):
        return tuple((t.data_ptr(), t._version) for t in (*self.parameters(), *self.buffers()))

    def folded_chains(self):
        if self.training:
            raise NotImplementedError("the fused chains are eval-only: call .eval()")
        key = self._weights_key()
        if getattr(self, "_fold_key", None) != key:
            with torch.no_grad():
                self._fold_value = self._fold()
            self._fold_key = key
        return self._fold_value


class MiniPointNet(_FoldCache):
    """Per-point MLP -> global max-pool -> hidden MLP [-> fc]."""

    def __init__(self, in_channels: int, per_point_mlp: Sequence[int], hidden_mlp: Sequence[int],
                 output_size: int = 0, fused_eval: bool = True, device=None):
        super().__init__()
        self.per_point = MLP(in_channels, per_point_mlp, device=device)
        self.hidden = MLP(per_point_mlp[-1], hidden_mlp, device=device)
        self.fc = (nn.Linear(hidden_mlp[-1], output_size, device=device)
                   if output_size > 0 else None)
        self.fused_eval = fused_eval

    def _fold(self):
        return FoldedChain(self.per_point.folded())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, hidden_mlp[-1] or output_size)."""
        if self.fused_eval:
            _, x = fused_pointnet_encoder(x, self.folded_chains())
        else:
            x = self.per_point(x).amax(dim=1)
        x = self.hidden(x)
        if self.fc is not None:
            x = self.fc(x)
        return x


class SegPointNet(_FoldCache):
    """Per-point mlp1 with a layer-1 tap, global max-pool broadcast back per
    point, mlp2, and a plain head: x (B, N, C) -> (B, N, output_size)."""

    TAP_AT = 1

    def __init__(self, in_channels: int, per_point_mlp1: Sequence[int],
                 per_point_mlp2: Sequence[int], output_size: int,
                 fused_eval: bool = True, device=None):
        super().__init__()
        widths = [in_channels] + list(per_point_mlp1)
        for i, ch in enumerate(per_point_mlp1):
            self.add_module(f"mlp1_{i}", MLP(widths[i], [ch], device=device))
        c_tap, c_pool = per_point_mlp1[self.TAP_AT], per_point_mlp1[-1]
        widths = [c_tap + c_pool] + list(per_point_mlp2)
        for i, ch in enumerate(per_point_mlp2):
            self.add_module(f"mlp2_{i}", MLP(widths[i], [ch], device=device))
        self.fc = nn.Linear(per_point_mlp2[-1], output_size, device=device)
        self.n1, self.n2 = len(per_point_mlp1), len(per_point_mlp2)
        self.c_tap = c_tap
        self.fused_eval = fused_eval

    def _fold(self):
        mlp1 = [getattr(self, f"mlp1_{i}").layer0.folded() for i in range(self.n1)]
        mlp2 = [getattr(self, f"mlp2_{i}").layer0.folded() for i in range(self.n2)]
        head = (self.fc.weight.t().contiguous(), self.fc.bias)
        return FoldedChain(mlp1), FoldedChain(mlp2 + [head], split=self.c_tap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_eval:
            chain1, chain2 = self.folded_chains()
            tap, pooled = fused_pointnet_encoder(x, chain1, tap_at=self.TAP_AT)
            return fused_seg_head(tap, pooled, chain2)
        tap = None
        for i in range(self.n1):
            x = getattr(self, f"mlp1_{i}")(x)
            if i == self.TAP_AT:
                tap = x
        pooled = x.amax(dim=1, keepdim=True).expand(-1, x.shape[1], -1)
        x = torch.cat([tap, pooled], dim=-1)
        for i in range(self.n2):
            x = getattr(self, f"mlp2_{i}")(x)
        return self.fc(x)


class SetAbstraction(_FoldCache):
    """Single-scale-grouping SA layer.

    Centroids: FPS when use_fps, else the first `npoint` points; neighbors:
    ball query with pad-with-first; features: [centred xyz (/radius if
    normalize_xyz) || grouped features] -> shared MLP -> max over nsample.
    `in_features` is the width of the point features (0: none).
    """

    def __init__(self, in_features: int, mlp: Sequence[int], radius: float, nsample: int,
                 use_xyz: bool = True, use_fps: bool = False, normalize_xyz: bool = False,
                 fused_eval: bool = True, fused_train: bool = False, device=None):
        super().__init__()
        c_in = in_features + 3 if (use_xyz or in_features == 0) else in_features
        self.mlp_shared = MLP(c_in, mlp, device=device)
        self.radius, self.nsample = radius, nsample
        self.use_xyz, self.use_fps, self.normalize_xyz = use_xyz, use_fps, normalize_xyz
        self.fused_eval, self.fused_train = fused_eval, fused_train

    def _fold(self):
        return self.mlp_shared.folded()

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], npoint: int):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, S, 3),
        new_features (B, S, mlp[-1]), sample_idxs (B, S) int32)."""
        B = xyz.shape[0]
        xyz = xyz.contiguous()
        if self.use_fps:
            fps = furthest_point_sample if self.fused_eval else furthest_point_sample_plain
            sample_idxs = fps(xyz, npoint)
        else:
            sample_idxs = torch.arange(npoint, dtype=torch.int32,
                                       device=xyz.device)[None].expand(B, npoint)
        new_xyz = gather_points(xyz, sample_idxs)
        kw = dict(radius=self.radius, normalize_xyz=self.normalize_xyz, use_xyz=self.use_xyz)
        if self.training:
            idx = ball_query(self.radius, self.nsample, xyz.detach(), new_xyz.detach())
            if (self.fused_train and features is not None
                    and len(list(self.mlp_shared.children())) == 3):
                out, stats = fused_sa_train_apply(xyz, features, new_xyz, idx, self.mlp_shared,
                                                  **kw)
                self.mlp_shared.update_batch_stats(stats)
                return new_xyz, out, sample_idxs
            grouped = group_inputs(xyz, features, new_xyz, idx, **kw)
            return new_xyz, self.mlp_shared(grouped).amax(dim=2), sample_idxs
        if self.fused_eval:
            out = fused_sa_apply(xyz, features, new_xyz, None, self.folded_chains(),
                                 nsample=self.nsample, **kw)
            return new_xyz, out, sample_idxs
        idx = ball_query(self.radius, self.nsample, xyz, new_xyz)  # (B, S, K)
        grouped = group_inputs(xyz, features, new_xyz, idx, **kw)
        return new_xyz, self.mlp_shared(grouped).amax(dim=2), sample_idxs


class PointnetBackbone(nn.Module):
    """3-layer SSG PointNet++ encoder: radii 0.3/0.5/0.7, nsample 32, FPS (if
    enabled) at layer 1 only; layers 2-3 take the first npoint centroids."""

    SPECS = (((64, 64, 128), 0.3), ((128, 128, 256), 0.5), ((256, 256, 256), 0.7))
    OUT_CHANNELS = SPECS[-1][0][-1]

    def __init__(self, use_fps: bool = False, normalize_xyz: bool = False,
                 input_channels: int = 0, fused_eval: bool = True, fused_train: bool = False,
                 device=None):
        super().__init__()
        c = input_channels
        for i, (mlp, radius) in enumerate(self.SPECS):
            self.add_module(f"sa{i}", SetAbstraction(
                c, mlp, radius, 32, use_xyz=True, use_fps=use_fps and i == 0,
                normalize_xyz=normalize_xyz, fused_eval=fused_eval, fused_train=fused_train,
                device=device))
            c = mlp[-1]

    def forward(self, pointcloud: torch.Tensor, numpoints: Sequence[int]):
        """pointcloud (B, N, 3 + input_channels) -> (xyz (B, S3, 3),
        features (B, S3, 256), sample_idxs of layer 1 (B, S1))."""
        xyz = pointcloud[..., 0:3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        first_idxs = None
        for i in range(len(self.SPECS)):
            xyz, features, idxs = getattr(self, f"sa{i}")(xyz, features, numpoints[i])
            if i == 0:
                first_idxs = idxs
        return xyz, features, first_idxs
