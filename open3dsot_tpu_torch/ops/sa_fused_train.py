"""Training-mode set abstraction, port of `open3dsot_tpu/ops/sa_fused_train.py`
(kernel K6).

One SA layer of PointNet++ in training mode, from the ball-query indices
on: layer 1 in A-form (`ops/sa_fused.py::a_form`, torch.matmul, as JAX
leaves it to XLA), y1 = a[idx] + ct over the (B, S, K) grid, three
BatchNorms at the statistics of this batch (mean and biased variance
E[y^2] - E[y]^2 over all B * S * K rows, as flax computes them), ReLU, and
the max over the K neighbours. The backward is the exact BN-training chain
rule, the max gradient split evenly over exact ties (as JAX's reduce_max
VJP), dW = h^T dy over all rows, da as a scatter-add of dy1 and dct =
sum_k dy1; the gradients of the Dense biases b2 and b3, which feed a
BatchNorm, are exactly 0 (sum of yhat is 0) and returned as zeros. Autograd
of `a_form` gives dW1, db1, dfeatures, dxyz and dnew_xyz from (da, dct).

The running statistics are not updated here: `fused_sa_train_apply`
returns each layer's (batch mean, batch variance) and the caller blends
them in (models/layers.py::MLP.update_batch_stats).

`sa_train_fwd_plain` / `sa_train_bwd_plain` are the plain PyTorch version:
the whole-grid form of the JAX package's `_ref_fwd` and `_manual_vjp_math`.
`_SATrainFunction` (a torch.autograd.Function) runs them for CPU tensors and
launches the kernel (csrc/sa_fused_train.cu, entries `sa_train_fwd` and
`sa_train_bwd`; the design note is there) for CUDA tensors, or raises.
Launches are counted in `fused_sa_train_apply.fwd_launches` and
`.bwd_launches`. The kernel computes its grid products in 3xTF32 on the
tensor cores; the wrapper packs W2, W3 (forward) and W2^T, W3^T (backward)
for them with `ops/chain_fused.py::pack_chunks`.

The forward keeps the pre-BN grids y2, y3 (B, S, K, C) for the backward;
y1 = a[idx] + ct is gathered again from the inputs a, ct and idx, which
the backward takes in its place (one f32 add: the same values). The plain
version computes the folds and masks with the kernel's rounding (relu(y *
s + t) as two rounded ops, 1 / sqrt(var + eps), g / cnt), so on the same
grids both select the same maxima, ties and ReLU masks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of
from open3dsot_tpu_torch.ops.chain_fused import pack_chunks
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.sa_fused import a_form

BN_EPS = 1e-5
_ERRORS = {-1: "B, N, S, K not accepted (B * S * K <= 33,553,920 rows)",
           -2: "a width C1, C2 or C3 is not a multiple of 4",
           -3: "a packed weight has the wrong size",
           -4: "a width too large for the tensor-core products' shared memory"}

Stats = Tuple[torch.Tensor, ...]  # (mean1, var1, mean2, var2, mean3, var3)


def _stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance mean(y^2) - mean(y)^2) over every axis but the last."""
    dims = tuple(range(y.dim() - 1))
    mean = y.mean(dims)
    return mean, (y * y).mean(dims) - mean * mean


def _fold(mean, var, gamma, beta):
    """(s, t, inv): BatchNorm at (mean, var) as y * s + t; inv = 1 / sqrt(var + eps)."""
    inv = 1.0 / torch.sqrt(var + BN_EPS)
    s = gamma * inv
    return s, beta - mean * s, inv


def _relu_fold(y, s, t):
    return torch.relu(y * s + t)


def _y1(a, ct, idx):
    """y1 = a[idx] + ct, the (B, S, K, C1) grid of layer 1."""
    return group_points(a, idx) + ct[:, :, None, :]


def sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn: Sequence[torch.Tensor]):
    """The plain forward: a (B, N, C1), ct (B, S, C1), idx (B, S, K), w2 (C1,
    C2), w3 (C2, C3), bn = (g1, bt1, g2, bt2, g3, bt3) -> (out (B, S, C3),
    stats, grids (y2, y3))."""
    y1 = _y1(a, ct, idx)
    m1, v1 = _stats(y1)
    s1, t1, _ = _fold(m1, v1, bn[0], bn[1])
    y2 = _relu_fold(y1, s1, t1) @ w2 + b2
    m2, v2 = _stats(y2)
    s2, t2, _ = _fold(m2, v2, bn[2], bn[3])
    y3 = _relu_fold(y2, s2, t2) @ w3 + b3
    m3, v3 = _stats(y3)
    s3, t3, _ = _fold(m3, v3, bn[4], bn[5])
    out = _relu_fold(y3, s3, t3).amax(dim=2)
    return out, (m1, v1, m2, v2, m3, v3), (y2, y3)


def _bn_bwd(dz, yh, s, M: float):
    """BN-training backward with the global sums: -> (dy, dgamma, dbeta)."""
    dbeta = dz.sum((0, 1, 2))
    dgamma = (dz * yh).sum((0, 1, 2))
    return s * (dz - dbeta / M - yh * (dgamma / M)), dgamma, dbeta


def sa_train_bwd_plain(g_out, a, ct, idx, grids, stats: Stats, w2, w3,
                       bn: Sequence[torch.Tensor]):
    """The plain backward from the forward's inputs a, ct, idx, its grids
    (y2, y3) and statistics, and the cotangent g_out (B, S, C3) -> (da (B, N,
    C1), dct (B, S, C1), dw2, dw3, (dg1, dbt1, dg2, dbt2, dg3, dbt3))."""
    grids = (_y1(a, ct, idx), *grids)
    B, S, K, C1 = grids[0].shape
    n_points = a.shape[1]
    M = float(B * S * K)
    folds = [_fold(stats[2 * i], stats[2 * i + 1], bn[2 * i], bn[2 * i + 1]) for i in range(3)]
    h1, h2, h3 = (_relu_fold(y, s, t) for y, (s, t, _) in zip(grids, folds))
    yh1, yh2, yh3 = ((y - stats[2 * i]) * folds[i][2] for i, y in enumerate(grids))

    # B1: the max gradient, split over tied maxima, times relu'
    mask = (h3 == h3.amax(dim=2, keepdim=True)).to(h3.dtype)
    dz3 = (g_out[:, :, None, :] * mask / mask.sum(dim=2, keepdim=True)) * (h3 > 0)
    dy3, dg3, dbt3 = _bn_bwd(dz3, yh3, folds[2][0], M)
    # B2, B3
    dw3 = torch.einsum("bskc,bskd->cd", h2, dy3)
    dy2, dg2, dbt2 = _bn_bwd((dy3 @ w3.t()) * (h2 > 0), yh2, folds[1][0], M)
    dw2 = torch.einsum("bskc,bskd->cd", h1, dy2)
    dy1, dg1, dbt1 = _bn_bwd((dy2 @ w2.t()) * (h1 > 0), yh1, folds[0][0], M)
    # B4: scatter-add into the N points, sum over the K neighbours
    rows = (idx.long() + n_points * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
    da = torch.zeros(B * n_points, C1, dtype=dy1.dtype, device=dy1.device)
    da.index_add_(0, rows, dy1.reshape(-1, C1))
    return (da.reshape(B, n_points, C1), dy1.sum(dim=2), dw2, dw3,
            (dg1, dbt1, dg2, dbt2, dg3, dbt3))


def _library():
    from open3dsot_tpu_torch.ops._build import load_library

    return load_library("sa_fused_train").lib


def _dims(idx, n_points, c1, c2, c3):
    B, S, K = idx.shape
    return B, n_points, S, K, c1, c2, c3


def _workspace(dims, backward: bool, device) -> torch.Tensor:
    nbytes = _library().sa_train_workspace(*dims, int(backward))
    raise_on(min(nbytes, 0), "K6 sa_train_workspace", _ERRORS)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _packed(name: str, w: torch.Tensor) -> torch.Tensor:
    """w (in, out) packed for the tensor cores; its size checked against the C side's rule."""
    p = pack_chunks(w)
    n = _library().sa_train_packed_floats(w.shape[0], w.shape[1])
    if p.numel() != n:
        raise RuntimeError(f"K6: {name} packed to {p.numel()} floats, the kernel reads {n}")
    return p


def sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn: Sequence[torch.Tensor]):
    """K6 forward on the card: the same function as `sa_train_fwd_plain`."""
    B, N, C1 = a.shape
    S, K = idx.shape[1], idx.shape[2]
    C2, C3 = w2.shape[1], w3.shape[1]
    dev = a.device
    check("a", a, dev, (B, N, C1))
    check("ct", ct, dev, (B, S, C1))
    check("idx", idx, dev, (B, S, K), dtype=torch.int32)
    for name, t, shape in (("w2", w2, (C1, C2)), ("b2", b2, (C2,)), ("w3", w3, (C2, C3)),
                           ("b3", b3, (C3,))):
        check(name, t, dev, shape)
    bn_flat = torch.cat([p.reshape(-1) for p in bn])
    check("bn", bn_flat, dev, (2 * (C1 + C2 + C3),))
    dims = _dims(idx, N, C1, C2, C3)
    w2p, w3p = _packed("W2", w2), _packed("W3", w3)
    grids = tuple(torch.empty(B, S, K, c, device=dev) for c in (C2, C3))
    out = torch.empty(B, S, C3, device=dev)
    stats = torch.empty(2 * (C1 + C2 + C3), device=dev)
    ws = _workspace(dims, False, dev)
    rc = _library().sa_train_fwd(
        a.data_ptr(), ct.data_ptr(), idx.data_ptr(), w2p.data_ptr(), w2p.numel(),
        b2.data_ptr(), w3p.data_ptr(), w3p.numel(), b3.data_ptr(), bn_flat.data_ptr(),
        grids[0].data_ptr(), grids[1].data_ptr(), out.data_ptr(), stats.data_ptr(),
        ws.data_ptr(), *dims, stream_of(a))
    raise_on(rc, "K6 sa_train_fwd", _ERRORS)
    fused_sa_train_apply.fwd_launches += 1
    return out, tuple(torch.split(stats, [C1, C1, C2, C2, C3, C3])), grids


def sa_train_bwd_kernel(g_out, a, ct, idx, grids, stats: Stats, w2, w3,
                        bn: Sequence[torch.Tensor]):
    """K6 backward on the card: the same function as `sa_train_bwd_plain`."""
    y2, y3 = grids
    B, N, C1 = a.shape
    S, K = idx.shape[1], idx.shape[2]
    C2, C3 = y2.shape[3], y3.shape[3]
    dev = a.device
    check("g_out", g_out, dev, (B, S, C3))
    check("a", a, dev, (B, N, C1))
    check("ct", ct, dev, (B, S, C1))
    check("idx", idx, dev, (B, S, K), dtype=torch.int32)
    for name, t, c in (("y2", y2, C2), ("y3", y3, C3)):
        check(name, t, dev, (B, S, K, c))
    if tuple(w2.shape) != (C1, C2) or tuple(w3.shape) != (C2, C3):
        raise ValueError(f"w2, w3 must be ({C1}, {C2}), ({C2}, {C3}), got "
                         f"{tuple(w2.shape)}, {tuple(w3.shape)}")
    stats_flat = torch.cat([s.reshape(-1) for s in stats])
    bn_flat = torch.cat([p.reshape(-1) for p in bn])
    check("stats", stats_flat, dev, (2 * (C1 + C2 + C3),))
    check("bn", bn_flat, dev, (2 * (C1 + C2 + C3),))
    dims = _dims(idx, N, C1, C2, C3)
    w2tp, w3tp = _packed("W2^T", w2.t()), _packed("W3^T", w3.t())
    da = torch.empty(B, N, C1, device=dev)
    dct = torch.empty(B, S, C1, device=dev)
    dw2 = torch.empty(C1, C2, device=dev)
    dw3 = torch.empty(C2, C3, device=dev)
    dbn = torch.empty(2 * (C1 + C2 + C3), device=dev)
    ws = _workspace(dims, True, dev)
    rc = _library().sa_train_bwd(
        g_out.data_ptr(), a.data_ptr(), ct.data_ptr(), idx.data_ptr(), y2.data_ptr(),
        y3.data_ptr(), stats_flat.data_ptr(), w2tp.data_ptr(), w2tp.numel(), w3tp.data_ptr(),
        w3tp.numel(), bn_flat.data_ptr(), da.data_ptr(), dct.data_ptr(), dw2.data_ptr(),
        dw3.data_ptr(), dbn.data_ptr(), ws.data_ptr(), *dims, stream_of(g_out))
    raise_on(rc, "K6 sa_train_bwd", _ERRORS)
    fused_sa_train_apply.bwd_launches += 1
    return da, dct, dw2, dw3, tuple(torch.split(dbn, [C1, C1, C2, C2, C3, C3]))


class _SATrainFunction(torch.autograd.Function):
    """(a, ct, w2, b2, w3, b3, g1, bt1, g2, bt2, g3, bt3, idx) -> (out, *stats);
    the stats carry no gradient."""

    @staticmethod
    def forward(ctx, a, ct, w2, b2, w3, b3, g1, bt1, g2, bt2, g3, bt3, idx):
        bn = (g1, bt1, g2, bt2, g3, bt3)
        if on_cuda(a):
            out, stats, grids = sa_train_fwd_kernel(a, ct, idx, w2.contiguous(), b2,
                                                    w3.contiguous(), b3, bn)
        else:
            out, stats, grids = sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn)
        ctx.save_for_backward(a, ct, idx, w2, w3, *bn)
        ctx.grids, ctx.stats = grids, stats
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g_out, *_):
        a, ct, idx, w2, w3, *bn = ctx.saved_tensors
        bwd = sa_train_bwd_kernel if on_cuda(g_out) else sa_train_bwd_plain
        da, dct, dw2, dw3, dbn = bwd(g_out.contiguous(), a, ct, idx, ctx.grids, ctx.stats, w2,
                                     w3, bn)
        # the Dense biases feeding a BatchNorm: exactly 0
        db2, db3 = w2.new_zeros(w2.shape[1]), w3.new_zeros(w3.shape[1])
        return (da, dct, dw2, db2, dw3, db3, *dbn, None)


def fused_sa_train_apply(xyz: torch.Tensor, features: Optional[torch.Tensor],
                         new_xyz: torch.Tensor, idx: torch.Tensor, mlp: nn.Module, *,
                         radius: float, normalize_xyz: bool, use_xyz: bool
                         ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """K6: xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, S, 3), idx
    (B, S, K) int32 ball-query indices, mlp the SA's 3-layer `mlp_shared`
    (models/layers.py::MLP) -> (out (B, S, C3), [(batch mean, batch var)]
    of each layer). Differentiable in the MLP's parameters, xyz, features and
    new_xyz."""
    layers = list(mlp.children())
    if len(layers) != 3:
        raise ValueError(f"the fused training SA takes 3 layers, got {len(layers)}")
    if tuple(idx.shape[:2]) != (xyz.shape[0], new_xyz.shape[1]):
        raise ValueError(f"idx must be (B, S, K), got {tuple(idx.shape)}")
    dense = [layer.dense for layer in layers]
    bns = [layer.bn for layer in layers]
    inv_r = 1.0 / radius if normalize_xyz else 1.0
    a, ct = a_form(xyz, features, new_xyz, dense[0].weight.t(), dense[0].bias, inv_r=inv_r,
                   use_xyz=use_xyz)
    out, *stats = _SATrainFunction.apply(
        a, ct, dense[1].weight.t(), dense[1].bias, dense[2].weight.t(), dense[2].bias,
        bns[0].weight, bns[0].bias, bns[1].weight, bns[1].bias, bns[2].weight, bns[2].bias,
        idx.int().contiguous())
    return out, [(stats[2 * i], stats[2 * i + 1]) for i in range(3)]


fused_sa_train_apply.fwd_launches = 0
fused_sa_train_apply.bwd_launches = 0


def reset_launch_counts() -> None:
    fused_sa_train_apply.fwd_launches = 0
    fused_sa_train_apply.bwd_launches = 0
