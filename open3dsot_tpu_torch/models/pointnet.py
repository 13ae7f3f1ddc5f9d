"""PointNet encoders, port of `open3dsot_tpu/models/pointnet.py`:
MiniPointNet and SegPointNet of M2-Track (reference
models/backbone/pointnet.py:91-204), SetAbstraction and PointnetBackbone of
BAT/P2B (pointnet2_modules.py:24-149, pointnet.py:12-88).

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
        c_in = in_features + 3 if (use_xyz or in_features == 0) else in_features
        self.mlp_shared = MLP(c_in, mlp, device=device, dtype=dtype)
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
