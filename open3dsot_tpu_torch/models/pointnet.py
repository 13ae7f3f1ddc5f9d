"""PointNet encoders, port of `open3dsot_tpu/models/pointnet.py`:
MiniPointNet and SegPointNet of M2-Track (reference
models/backbone/pointnet.py:91-204), SetAbstraction and PointnetBackbone of
BAT/P2B (pointnet2_modules.py:24-149, pointnet.py:12-88), and the rest of
the layer library, which no tracker instantiates (in the reference or
here): SetAbstractionMSG, SetAbstractionAll and FeaturePropagation
(pointnet2_modules.py:82-118, pointnet2_utils.py:342-385,
pointnet2_modules.py:152-212), plain PyTorch in eval and in training, as
JAX's are unfused.

With `fused_eval` (the default) the eval forward goes through the kernels:
K1/K2 (ops/chain_fused.py) for the M2 encoders, K3 (ops/sampling.py) and
K4 (ops/sa_fused.py) for the SA layers. `fused_eval=False` is the plain
PyTorch forward that the kernels are held against: the layer stack with
BatchNorm unfolded, and for SA the plain FPS, ball query and grouping. The
folded weights (for SA with K4's packed form of them) are cached and folded
again whenever a parameter or buffer changes: a load_state_dict (in-place copy, bumping the tensor version), a
.to() (new storage) or a training step (optimizer and running-statistics
updates are in place).

In training mode (`.train()`) an SA layer takes K6 (ops/sa_fused_train.py)
when `fused_train` is set, it has point features and a 3-layer MLP, as the
JAX package selects it (pointnet.py:192-216); every other SA layer (the
featureless first one, the RPN's vote layer) runs the plain grid MLP with
training BatchNorm under autograd, and `amax` over the K neighbours, whose
gradient is split over ties as JAX's. FPS stays K3 when `fused_eval` is
set. The M2 encoders (MiniPointNet, SegPointNet) train on the plain layers
with training BatchNorm: K1/K2 are eval-only, in JAX too (pointnet.py:50,
:86).

`dtype=torch.bfloat16` is the bf16 compute mode (JAX `dtype=`): in eval
K1/K2/K4 in their bf16 mode with `fused_eval`, the flax-order bf16 layers
(models/layers.py) without; in training K6 in its bf16 mode and the
flax-order bf16 layers elsewhere; xyz, K3 and the ball query stay f32. The fold
caches key on the mode as well as on the weights, so a module switched
between modes (layers.py::set_compute_dtype) never reuses the other mode's
packing.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP, linear
from open3dsot_tpu_torch.ops.chain_fused import BF16, is_bf16
from open3dsot_tpu_torch.ops.chain_fused import (
    FoldedChain,
    fused_pointnet_encoder,
    fused_seg_head,
)
from open3dsot_tpu_torch.ops.grouping import gather_points
from open3dsot_tpu_torch.ops.interpolate import three_interpolate, three_nn
from open3dsot_tpu_torch.ops.neighbors import ball_query
from open3dsot_tpu_torch.ops.sa_fused import FoldedSA, fused_sa_apply, group_inputs
from open3dsot_tpu_torch.ops.sa_fused_train import Packs, fused_sa_train_apply
from open3dsot_tpu_torch.ops.sampling import furthest_point_sample, furthest_point_sample_plain


def weights_key(module: nn.Module):
    """Changes whenever a parameter or buffer of `module` is replaced or
    written in place (its storage pointer or its version counter)."""
    return tuple((t.data_ptr(), t._version) for t in (*module.parameters(), *module.buffers()))


def _fold_parts(value) -> tuple:
    """A fold cache's value as its parts: SegPointNet folds into a tuple of
    two FoldedChains, the others into one FoldedChain or FoldedSA."""
    return value if type(value) is tuple else (value,)


class _FoldCache(nn.Module):
    """Caches `self._fold()` until a parameter or buffer, or the compute
    dtype (`self.dtype`), changes."""

    _fold_buffers = None  # the buffers' names, inside `folds_as_buffers`

    def _cached(self, name: str, key, build):
        """build() (without autograd), held as `_<name>_value` until `key` changes."""
        if getattr(self, f"_{name}_key", None) != key:
            with torch.no_grad():
                setattr(self, f"_{name}_value", build())
            setattr(self, f"_{name}_key", key)
        return getattr(self, f"_{name}_value")

    def folded_chains(self):
        if self.training:
            raise NotImplementedError("the fused chains are eval-only: call .eval()")
        if self._fold_buffers is not None:
            tensors = [getattr(self, name) for name in self._fold_buffers]
            parts = []
            for part in _fold_parts(self._fold_value):
                n = len(part.tensors())
                parts.append(part.with_tensors(tensors[:n]))
                tensors = tensors[n:]
            return tuple(parts) if type(self._fold_value) is tuple else parts[0]
        return self._cached("fold", (weights_key(self), self.dtype), self._fold)


@contextlib.contextmanager
def folds_as_buffers(net: nn.Module):
    """Inside: every fold cache of `net` folded once, now, its folded and
    packed tensors held as buffers of its module (`folded_<i>`, copies), and
    `folded_chains()` rebuilding its value from those buffers without
    folding again or reading data pointers. torch.export traces a module
    with its buffers as the program's own, so an exported step carries the
    weights its kernels read and traces no fold (`weights_key` reads data
    pointers, which a traced tensor has none of). Undone on exit."""
    caches = [m for m in net.modules() if isinstance(m, _FoldCache)]
    added = {m: [] for m in caches}  # what the finally removes, even after a partial fold
    try:
        for m in caches:
            tensors = [t for part in _fold_parts(m.folded_chains()) for t in part.tensors()]
            for i, t in enumerate(tensors):
                added[m].append(f"folded_{i}")
                m.register_buffer(f"folded_{i}", t.detach().clone())
            m._fold_buffers = added[m]
        yield
    finally:
        for m, names in added.items():
            for name in names:
                m._buffers.pop(name, None)
            m._fold_buffers = None


class MiniPointNet(_FoldCache):
    """Per-point MLP -> global max-pool -> hidden MLP [-> fc]."""

    def __init__(self, in_channels: int, per_point_mlp: Sequence[int], hidden_mlp: Sequence[int],
                 output_size: int = 0, fused_eval: bool = True, device=None, dtype=None):
        super().__init__()
        self.per_point = MLP(in_channels, per_point_mlp, device=device, dtype=dtype)
        self.hidden = MLP(per_point_mlp[-1], hidden_mlp, device=device, dtype=dtype)
        self.fc = (nn.Linear(hidden_mlp[-1], output_size, device=device)
                   if output_size > 0 else None)
        self.fused_eval = fused_eval
        self.dtype = BF16 if is_bf16(dtype) else None

    def _fold(self):
        return FoldedChain(self.per_point.folded(), dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, hidden_mlp[-1] or output_size); bf16 in the bf16 mode."""
        if self.fused_eval and not self.training:
            _, x = fused_pointnet_encoder(x, self.folded_chains())
        else:
            x = self.per_point(x).amax(dim=1)
        x = self.hidden(x)
        if self.fc is not None:
            x = linear(x, self.fc, self.dtype)
        return x


class SegPointNet(_FoldCache):
    """Per-point mlp1 with a layer-1 tap, global max-pool broadcast back per
    point, mlp2, and a plain head: x (B, N, C) -> (B, N, output_size)."""

    TAP_AT = 1

    def __init__(self, in_channels: int, per_point_mlp1: Sequence[int],
                 per_point_mlp2: Sequence[int], output_size: int,
                 fused_eval: bool = True, device=None, dtype=None):
        super().__init__()
        widths = [in_channels] + list(per_point_mlp1)
        for i, ch in enumerate(per_point_mlp1):
            self.add_module(f"mlp1_{i}", MLP(widths[i], [ch], device=device, dtype=dtype))
        c_tap, c_pool = per_point_mlp1[self.TAP_AT], per_point_mlp1[-1]
        widths = [c_tap + c_pool] + list(per_point_mlp2)
        for i, ch in enumerate(per_point_mlp2):
            self.add_module(f"mlp2_{i}", MLP(widths[i], [ch], device=device, dtype=dtype))
        self.fc = nn.Linear(per_point_mlp2[-1], output_size, device=device)
        self.n1, self.n2 = len(per_point_mlp1), len(per_point_mlp2)
        self.c_tap = c_tap
        self.fused_eval = fused_eval
        self.dtype = BF16 if is_bf16(dtype) else None

    def _fold(self):
        mlp1 = [getattr(self, f"mlp1_{i}").layer0.folded() for i in range(self.n1)]
        mlp2 = [getattr(self, f"mlp2_{i}").layer0.folded() for i in range(self.n2)]
        head = (self.fc.weight.t().contiguous(), self.fc.bias)
        return (FoldedChain(mlp1, dtype=self.dtype),
                FoldedChain(mlp2 + [head], split=self.c_tap, dtype=self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """-> (B, N, output_size): f32 from K2, bf16 from the plain bf16 stack."""
        if self.fused_eval and not self.training:
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
        return linear(x, self.fc, self.dtype)


class SetAbstraction(_FoldCache):
    """Single-scale-grouping SA layer.

    Centroids: FPS when use_fps, else the first `npoint` points; neighbors:
    ball query with pad-with-first; features: [centred xyz (/radius if
    normalize_xyz) || grouped features] -> shared MLP -> max over nsample.
    `in_features` is the width of the point features (0: none).
    """

    def __init__(self, in_features: int, mlp: Sequence[int], radius: float, nsample: int,
                 use_xyz: bool = True, use_fps: bool = False, normalize_xyz: bool = False,
                 fused_eval: bool = True, fused_train: bool = False, device=None, dtype=None):
        super().__init__()
        self.mlp_shared = MLP(_sa_in_width(in_features, use_xyz), mlp, device=device, dtype=dtype)
        self.radius, self.nsample = radius, nsample
        self.use_xyz, self.use_fps, self.normalize_xyz = use_xyz, use_fps, normalize_xyz
        self.fused_eval, self.fused_train = fused_eval, fused_train
        self.dtype = BF16 if is_bf16(dtype) else None

    def _fold(self):
        # on a CUDA device, packed for K4 here, once per change of the weights or mode
        return FoldedSA(self.mlp_shared.folded(), dtype=self.dtype)

    def train_packs(self) -> Packs:
        """K6's packed W2, W3 in this layer's mode, held as the folds are. The
        key is the Dense layers 2-3 and the mode: every training forward
        writes the BatchNorms' running statistics, so `weights_key(self)`
        would pack again between the template's and the search's calls of
        one step."""
        dense = [layer.dense for layer in list(self.mlp_shared.children())[1:]]
        key = (tuple(weights_key(d) for d in dense), self.dtype)
        return self._cached("k6_packs", key, lambda: Packs(
            dense[0].weight.t(), dense[1].weight.t(), self.dtype is not None))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], npoint: int):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, S, 3),
        new_features (B, S, mlp[-1]) (bf16 in the bf16 mode), sample_idxs (B, S)
        int32)."""
        xyz = xyz.contiguous()
        fps = furthest_point_sample if self.fused_eval else furthest_point_sample_plain
        new_xyz, sample_idxs = _centroids(xyz, npoint, fps if self.use_fps else None)
        kw = dict(radius=self.radius, normalize_xyz=self.normalize_xyz, use_xyz=self.use_xyz)
        if self.training:
            idx = ball_query(self.radius, self.nsample, xyz.detach(), new_xyz.detach())
            if (self.fused_train and features is not None
                    and len(list(self.mlp_shared.children())) == 3):
                packs = self.train_packs() if xyz.is_cuda else None
                out, stats = fused_sa_train_apply(xyz, features, new_xyz, idx, self.mlp_shared,
                                                  packs=packs, **kw)
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


def _centroids(xyz: torch.Tensor, npoint: int, fps=None):
    """An SA layer's centroids (B, S, 3) and their indices (B, S) int32: by
    `fps`, or the first `npoint` points where it is None."""
    if fps is not None:
        sample_idxs = fps(xyz, npoint)
    else:
        sample_idxs = torch.arange(npoint, dtype=torch.int32,
                                   device=xyz.device)[None].expand(xyz.shape[0], npoint)
    return gather_points(xyz, sample_idxs), sample_idxs


def _sa_in_width(in_features: int, use_xyz: bool) -> int:
    """The width of an SA MLP's input: centred xyz || features, or either alone."""
    return in_features + 3 if (use_xyz or in_features == 0) else in_features


class SetAbstractionMSG(nn.Module):
    """Multi-scale-grouping SA layer: one centroid set (FPS when use_fps,
    else the first `npoint` points), one branch `mlp_shared_{i}` per
    (radius, nsample, mlp) (ball query, grouping, shared MLP, max over the
    neighbours), the branches' outputs concatenated along the features.
    The plain path only (JAX pointnet.py:236-250): FPS is K3 on the card, as
    JAX's FPS is its Pallas kernel on the TPU; there is no fused branch."""

    def __init__(self, in_features: int, mlps: Sequence[Sequence[int]], radii: Sequence[float],
                 nsamples: Sequence[int], use_xyz: bool = True, use_fps: bool = False,
                 normalize_xyz: bool = False, device=None, dtype=None):
        super().__init__()
        if not len(mlps) == len(radii) == len(nsamples):
            raise ValueError("mlps / radii / nsamples must align (pointnet2_modules.py:104)")
        for i, mlp in enumerate(mlps):
            self.add_module(f"mlp_shared_{i}", MLP(_sa_in_width(in_features, use_xyz), mlp,
                                                   device=device, dtype=dtype))
        self.radii, self.nsamples = list(radii), list(nsamples)
        self.use_xyz, self.use_fps, self.normalize_xyz = use_xyz, use_fps, normalize_xyz

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor], npoint: int):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, S, 3),
        new_features (B, S, sum of the branches' mlp[-1]), sample_idxs (B, S))."""
        xyz = xyz.contiguous()
        new_xyz, sample_idxs = _centroids(xyz, npoint,
                                          furthest_point_sample if self.use_fps else None)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx = ball_query(radius, nsample, xyz.detach(), new_xyz.detach())
            grouped = group_inputs(xyz, features, new_xyz, idx, radius=radius,
                                   normalize_xyz=self.normalize_xyz, use_xyz=self.use_xyz)
            outs.append(getattr(self, f"mlp_shared_{i}")(grouped).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), sample_idxs


class SetAbstractionAll(nn.Module):
    """GroupAll SA layer: one group of every point, [xyz || features] ->
    shared MLP -> max over all N (pointnet2_utils.py:342-385)."""

    def __init__(self, in_features: int, mlp: Sequence[int], use_xyz: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.mlp_shared = MLP(_sa_in_width(in_features, use_xyz), mlp, device=device,
                              dtype=dtype)
        self.use_xyz = use_xyz

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, 1, 3)
        zeros, new_features (B, 1, mlp[-1]))."""
        grouped = xyz
        if features is not None:
            grouped = torch.cat([xyz, features], dim=-1) if self.use_xyz else features
        out = self.mlp_shared(grouped[:, None]).amax(dim=2)
        return xyz.new_zeros(xyz.shape[0], 1, 3), out


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance feature propagation (pointnet2_modules.py:152-212):
    the known features interpolated at the unknown points with weights
    1 / (d + 1e-8), normalised (or, where `known` is None, the known features
    broadcast over the unknown points), || the unknown points' own features,
    -> shared MLP. `in_features` is the MLP's input width."""

    def __init__(self, in_features: int, mlp: Sequence[int], device=None, dtype=None):
        super().__init__()
        self.mlp_shared = MLP(in_features, mlp, device=device, dtype=dtype)

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknown_feats: Optional[torch.Tensor], known_feats: torch.Tensor) -> torch.Tensor:
        """unknown (B, n, 3), known (B, m, 3) or None, unknown_feats (B, n, C1)
        or None, known_feats (B, m, C2) ((B, 1, C2) where known is None) ->
        (B, n, mlp[-1])."""
        if known is not None:
            dist, idx = three_nn(unknown, known)
            recip = 1.0 / (dist + 1e-8)
            interpolated = three_interpolate(known_feats, idx, recip / recip.sum(2, keepdim=True))
        else:
            interpolated = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                              known_feats.shape[-1])
        if unknown_feats is not None:
            interpolated = torch.cat([interpolated, unknown_feats], dim=-1)
        return self.mlp_shared(interpolated)


class PointnetBackbone(nn.Module):
    """3-layer SSG PointNet++ encoder: radii 0.3/0.5/0.7, nsample 32, FPS (if
    enabled) at layer 1 only; layers 2-3 take the first npoint centroids."""

    SPECS = (((64, 64, 128), 0.3), ((128, 128, 256), 0.5), ((256, 256, 256), 0.7))
    OUT_CHANNELS = SPECS[-1][0][-1]

    def __init__(self, use_fps: bool = False, normalize_xyz: bool = False,
                 input_channels: int = 0, fused_eval: bool = True, fused_train: bool = False,
                 device=None, dtype=None):
        super().__init__()
        c = input_channels
        for i, (mlp, radius) in enumerate(self.SPECS):
            self.add_module(f"sa{i}", SetAbstraction(
                c, mlp, radius, 32, use_xyz=True, use_fps=use_fps and i == 0,
                normalize_xyz=normalize_xyz, fused_eval=fused_eval, fused_train=fused_train,
                device=device, dtype=dtype))
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
