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
launches the kernels for CUDA tensors, or raises: csrc/sa_fused_train.cu
(entries `sa_train_fwd`, `sa_train_bwd`; 3xTF32 on the tensor cores) in the
f32 mode, csrc/sa_fused_train_bf16.cu (`sa_train_bf16_fwd`,
`sa_train_bf16_bwd`; bf16 wgmma) in the bf16 mode; the design notes are
there. Launches are counted in `fused_sa_train_apply.fwd_launches` and
`.bwd_launches` (either mode), and those of the bf16 mode in
`.bf16_fwd_launches` and `.bf16_bwd_launches` too. The backward adds da by
float atomics, or, under `torch.use_deterministic_algorithms(True)`, in a
fixed order (counted in `.ordered_bwd_launches` too): a resumed run then
matches an uninterrupted one bit for bit. The kernels take W2, W3
(forward) and W2^T, W3^T (backward) in the form their products read, built
by `Packs`; the SA layer holds them in its fold cache, built again only when
a weight or the mode changes (models/pointnet.py::SetAbstraction.train_packs).

The f32 mode keeps the pre-BN grids y2, y3 (B, S, K, C) for the backward;
y1 = a[idx] + ct is gathered again from the inputs a, ct and idx, which
the backward takes in its place (one f32 add: the same values). The plain
version computes the folds and masks with the kernel's rounding (relu(y *
s + t) as two rounded ops, 1 / sqrt(var + eps), g / cnt), so on the same
grids both select the same maxima, ties and ReLU masks.

The bf16 compute mode (the MLP's layers made with `dtype=torch.bfloat16`;
JAX `fused_sa_train_apply(dtype=jnp.bfloat16)`) rounds where the JAX
package's Pallas passes round (`_kf1`-`_kf4`, `_kb1`-`_kb4`; its `impl='ref'`
ignores the dtype). The A-form rows are gathered as bf16, as the compiled
TPU kernel gathers them (`i8g`, `int8_gather_default`: the exact bf16 byte
planes): y1 = bf16(a)[idx] + ct in f32, and so are its statistics; the
plain path rounds `a` once in `_SATrainFunction`, the kernel as it reads it.
The forward keeps the grids JAX's bf16 kernel keeps: h1 = bf16(relu(BN1(y1)))
and h2 = bf16(relu(BN2(y2))), (B, S, K, C) in bf16, and the backward computes
y2 = h1 W2 + b2 and y3 = h2 W3 + b3 again from them (bf16 operands, f32
sums); the statistics and the folds stay f32, the output is returned as
bf16. The kernel's forward keeps `mxt` (3, B, S, C3) too: the output (max_k
h3) in f32, the number of its ties and the sum of yhat3 over them, which its
backward reads. Backward: the dz grids are used as bf16 (the sums of the BN
backward take dz unrounded, as the Pallas passes sum it before they store
it), dW and dh take bf16 operands (h, dy, W^T), the ReLU masks are h > 0 of
the stored bf16 h, da scatter-sums bf16-rounded dy1 with f32 sums and dct
sums dy1 in f32. The mode comes from the MLP's layers (`DenseBNRelu.dtype`),
as K4's from `FoldedSA.dtype`.

Widths that are not a multiple of 4 run at the widths rounded up to 4
(`_padded_call`): a, ct, W2, W3, the biases and the BatchNorm parameters
zero-padded. A padded channel is 0 at every row, so its batch mean and
variance are 0, and with gamma = beta = 0 its scale and shift are 0: it
stays 0 through every layer, and its gradients are 0. The kernels' grids
keep the padded widths (the backward takes them as they are); out, the
statistics and the gradients are sliced to the real widths.

Under a process group whose statistics are those of the global batch
(`parallel/distributed.py::global_batch`, the trainer's default mode on
several ranks, as JAX's GSPMD step, whose partitioner adds K6's per-shard
partial sums up over the shards) the kernels run staged: each entry has a
`_staged` twin that stops where a pass's statistics are complete (at each
finalize of the single call), the wrapper sums the (2, C) float64 sums and
the row count over the group with one all_reduce (`_run_staged`), and the
next stage finalizes from them with the global count; the backward's
dgamma, dbeta stay each rank's own, to be averaged with the other
gradients. Three all_reduces a forward and three a backward; counted in
`.staged_fwd_launches` and `.staged_bwd_launches` (and in the launches of
either mode). The plain versions take the same sums (`global_stats`).
Elsewhere (one rank, or per-device statistics) the single calls run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of
from open3dsot_tpu_torch.ops.chain_fused import BF16, is_bf16, pack_chunks, pad_to, round4
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.sa_fused import a_form
from open3dsot_tpu_torch.parallel import distributed

BN_EPS = 1e-5
_ERRORS = {-1: "B, N, S or K not accepted (B * S * K below 2^31 rows)",
           -2: "a width C1, C2 or C3 is not a multiple of 4 (the wrappers pad them)",
           -3: "a packed weight has the wrong size",
           -6: "the CUDA driver refused a TMA tensor map of the bf16 mode"}

Stats = Tuple[torch.Tensor, ...]  # (mean1, var1, mean2, var2, mean3, var3)


def _stats(y: torch.Tensor, global_stats: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance mean(y^2) - mean(y)^2) over every axis but the
    last; with `global_stats` over the rows of every rank of the process
    group (their sums and count summed by all_reduce)."""
    dims = tuple(range(y.dim() - 1))
    if global_stats:
        C = y.shape[-1]
        sums = distributed.all_reduce_sum(torch.cat(
            [y.sum(dims), (y * y).sum(dims), y.new_full((1,), y.numel() // C)]))
        mean = sums[:C] / sums[-1]
        return mean, sums[C:2 * C] / sums[-1] - mean * mean
    mean = y.mean(dims)
    return mean, (y * y).mean(dims) - mean * mean


def _fold(mean, var, gamma, beta):
    """(s, t, inv): BatchNorm at (mean, var) as y * s + t; inv = 1 / sqrt(var + eps)."""
    inv = 1.0 / torch.sqrt(var + BN_EPS)
    s = gamma * inv
    return s, beta - mean * s, inv


def _relu_fold(y, s, t):
    return torch.relu(y * s + t)


def _rounder(bf16: bool):
    """x -> x rounded to bf16, in x's own dtype (float32, or float64 in the
    reference runs), in the bf16 mode; the identity in f32."""
    if not bf16:
        return lambda x: x
    return lambda x: x.to(BF16).to(x.dtype)


def _y1(a, ct, idx):
    """y1 = a[idx] + ct, the (B, S, K, C1) grid of layer 1."""
    return group_points(a, idx) + ct[:, :, None, :]


def sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn: Sequence[torch.Tensor],
                       bf16: bool = False, global_stats: bool = False):
    """The plain forward: a (B, N, C1), ct (B, S, C1), idx (B, S, K), w2 (C1,
    C2), w3 (C2, C3), bn = (g1, bt1, g2, bt2, g3, bt3) -> (out (B, S, C3),
    stats, grids): in f32 the pre-BN grids (y2, y3), in bf16 the activations
    (h1, h2) as bf16 tensors. `bf16`: the bf16 mode, with `a` already rounded
    to bf16 (`_SATrainFunction` rounds it); out is returned in a's dtype.
    `global_stats`: the statistics of the process group's global batch."""
    r = _rounder(bf16)
    y1 = _y1(a, ct, idx)
    m1, v1 = _stats(y1, global_stats)
    s1, t1, _ = _fold(m1, v1, bn[0], bn[1])
    h1 = r(_relu_fold(y1, s1, t1))
    y2 = h1 @ r(w2) + b2
    m2, v2 = _stats(y2, global_stats)
    s2, t2, _ = _fold(m2, v2, bn[2], bn[3])
    h2 = r(_relu_fold(y2, s2, t2))
    y3 = h2 @ r(w3) + b3
    m3, v3 = _stats(y3, global_stats)
    s3, t3, _ = _fold(m3, v3, bn[4], bn[5])
    out = _relu_fold(y3, s3, t3).amax(dim=2)
    grids = (h1.to(BF16), h2.to(BF16)) if bf16 else (y2, y3)
    return out, (m1, v1, m2, v2, m3, v3), grids


def _bn_bwd(dz, yh, s, M: float, r, global_stats: bool = False):
    """BN-training backward with the global sums: -> (dy, dgamma, dbeta). The
    sums take dz as it is, the body r(dz) (bf16-rounded in the bf16 mode,
    where the Pallas passes sum dz before they store it as bf16). With
    `global_stats` the body takes the sums and count of every rank of the
    process group, and dgamma, dbeta stay this rank's own."""
    dbeta = dz.sum((0, 1, 2))
    dgamma = (dz * yh).sum((0, 1, 2))
    sb, sg = dbeta, dgamma
    if global_stats:
        C = dz.shape[-1]
        sums = distributed.all_reduce_sum(torch.cat([dbeta, dgamma, dz.new_full((1,), M)]))
        sb, sg, M = sums[:C], sums[C:2 * C], sums[-1]
    return s * (r(dz) - sb / M - yh * (sg / M)), dgamma, dbeta


def sa_train_bwd_plain(g_out, a, ct, idx, grids, stats: Stats, w2, b2, w3, b3,
                       bn: Sequence[torch.Tensor], bf16: bool = False,
                       y3: Optional[torch.Tensor] = None, global_stats: bool = False):
    """The plain backward from the forward's inputs a, ct, idx, its grids and
    statistics, and the cotangent g_out (B, S, C3) -> (da (B, N, C1), dct (B,
    S, C1), dw2, dw3, (dg1, dbt1, dg2, dbt2, dg3, dbt3)). The grids are the
    forward's: (y2, y3) in f32; in bf16 (h1, h2), or the kernel forward's (h1,
    h2, mxt), from which y2 and y3 are computed again (b2, b3 are read only
    then). `y3` (bf16): the y3 of the kernel's max pass (`sa_train_fwd_kernel`'s
    `y3_out`), taken in place of h2 W3 + b3, so that the maxima and their ties
    are the kernel's. `bf16`: the bf16 mode (the module docstring), `a` as the
    forward took it. `global_stats`: the forward's statistics were the
    process group's, and so are the BN backward's sums (`_bn_bwd`)."""
    r = _rounder(bf16)
    y1 = _y1(a, ct, idx)
    B, S, K, C1 = y1.shape
    n_points = a.shape[1]
    M = float(B * S * K)
    folds = [_fold(stats[2 * i], stats[2 * i + 1], bn[2 * i], bn[2 * i + 1]) for i in range(3)]
    if bf16:
        h1, h2 = (h[..., :c].to(a.dtype) for h, c in zip(grids[:2], (C1, w2.shape[1])))
        y2 = h1 @ r(w2) + b2
        y3 = h2 @ r(w3) + b3 if y3 is None else y3
    else:
        y2, y3 = grids[:2]
        h1, h2 = (_relu_fold(y, s, t) for y, (s, t, _) in zip((y1, y2), folds))
    h3 = _relu_fold(y3, *folds[2][:2])
    yh1, yh2, yh3 = ((y - stats[2 * i]) * folds[i][2] for i, y in enumerate((y1, y2, y3)))

    # B1: the max gradient, split over tied maxima, times relu'
    mask = (h3 == h3.amax(dim=2, keepdim=True)).to(h3.dtype)
    dz3 = (g_out[:, :, None, :] * mask / mask.sum(dim=2, keepdim=True)) * (h3 > 0)
    dy3, dg3, dbt3 = _bn_bwd(dz3, yh3, folds[2][0], M, r, global_stats)
    # B2, B3
    dy3 = r(dy3)
    dw3 = torch.einsum("bskc,bskd->cd", h2, dy3)
    dy2, dg2, dbt2 = _bn_bwd((dy3 @ r(w3).t()) * (h2 > 0), yh2, folds[1][0], M, r,
                             global_stats)
    dy2 = r(dy2)
    dw2 = torch.einsum("bskc,bskd->cd", h1, dy2)
    dy1, dg1, dbt1 = _bn_bwd((dy2 @ r(w2).t()) * (h1 > 0), yh1, folds[0][0], M, r,
                             global_stats)
    # B4: scatter-add into the N points, sum over the K neighbours
    rows = (idx.long() + n_points * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
    da = torch.zeros(B * n_points, C1, dtype=dy1.dtype, device=dy1.device)
    da.index_add_(0, rows, r(dy1).reshape(-1, C1))  # dct below sums dy1 unrounded
    return (da.reshape(B, n_points, C1), dy1.sum(dim=2), dw2, dw3,
            (dg1, dbt1, dg2, dbt2, dg3, dbt3))


def _library(bf16: bool):
    from open3dsot_tpu_torch.ops._build import load_library

    return load_library("sa_fused_train_bf16" if bf16 else "sa_fused_train").lib


def _dims(idx, n_points, c1, c2, c3):
    B, S, K = idx.shape
    return B, n_points, S, K, c1, c2, c3


def _workspace(dims, backward: bool, bf16: bool, device) -> torch.Tensor:
    lib = _library(bf16)
    query = lib.sa_train_bf16_workspace if bf16 else lib.sa_train_workspace
    nbytes = query(*dims, int(backward))
    raise_on(min(nbytes, 0), "K6 workspace", _ERRORS)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _run_staged(call, widths: Sequence[int], rows: int, device) -> None:
    """A staged entry's stages 0-3: call(stage, sums) launches one; after
    stage k its (2, widths[k]) float64 sums, with the row count appended,
    are summed over the process group (distributed.all_reduce_sum) for
    stage k + 1 (csrc/k6_common.cuh, Staging)."""
    sums = torch.empty(2 * max(widths) + 1, dtype=torch.float64, device=device)
    for stage in range(4):
        call(stage, sums.data_ptr())
        if stage < 3:
            part = sums[:2 * widths[stage] + 1]
            part[-1:].fill_(float(rows))  # a fill kernel: `part[-1] = x` copies from the host
            distributed.all_reduce_sum(part)


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def bf16_rows(w: torch.Tensor) -> torch.Tensor:
    """w (n, k) as the bf16 mode's kernels read a weight: bf16, n rows of k
    inputs, the rows padded with zeros to a multiple of 8 (16 bytes, as TMA
    takes a row stride)."""
    n, k = w.shape
    out = torch.zeros(n, _round8(k), dtype=BF16, device=w.device)
    out[:, :k] = w
    return out


class Packs:
    """W2, W3 (the forward's) and W2^T, W3^T (the backward's) in the form
    one mode's kernels read them; the mode of the kernel calls that take
    them. 3xTF32: chunks split hi/lo (`pack_chunks`). bf16: each product's
    B operand K-major (`bf16_rows`): the forward's W2, W3 as the rows of
    W2^T, W3^T, the backward's W2^T, W3^T as the rows of W2, W3."""

    def __init__(self, w2: torch.Tensor, w3: torch.Tensor, bf16: bool):
        with torch.no_grad():
            w2, w3 = w2.detach().float(), w3.detach().float()
            if bf16:
                self.w2, self.w3, self.w2t, self.w3t = (bf16_rows(w) for w in (w2.t(), w3.t(), w2, w3))
            else:
                self.w2, self.w3, self.w2t, self.w3t = (pack_chunks(w) for w in (w2, w3, w2.t(), w3.t()))
        self.bf16 = bf16

    def check(self, *weights: Tuple[str, torch.Tensor, int, int]) -> None:
        """Each packed weight (k_in inputs, n_out outputs) against the form
        the kernels read."""
        for name, p, k_in, n_out in weights:
            if self.bf16:
                if p.dtype != BF16 or tuple(p.shape) != (n_out, _round8(k_in)):
                    raise RuntimeError(f"K6: {name} held as {p.dtype} {tuple(p.shape)}, the bf16 "
                                       f"kernels read bf16 ({n_out}, {_round8(k_in)})")
                continue
            n = _library(False).sa_train_packed_floats(k_in, n_out)
            if p.numel() != n:
                raise RuntimeError(f"K6: {name} packed to {p.numel()} floats, the kernel reads {n}")


def _padded_call(widths, w2, b2, w3, b3, bn, packs: Packs):
    """The weights, biases, BatchNorm parameters and packs of a K6 call at its
    widths (C1, C2, C3) rounded up to multiples of 4 (the module docstring).
    The 3xTF32 packs are the same at both widths (`pack_chunks` pads to whole
    chunks); the bf16 mode's rows are packed again."""
    C1, C2, C3 = widths
    P = [round4(c) for c in widths]
    w2p, w3p = pad_to(w2, P[0], P[1]), pad_to(w3, P[1], P[2])
    bnp = [pad_to(t.reshape(-1), P[i // 2]) for i, t in enumerate(bn)]
    packs_p = Packs(w2p, w3p, True) if packs.bf16 else packs
    return P, w2p, pad_to(b2, P[1]), w3p, pad_to(b3, P[2]), bnp, packs_p


def sa_train_fwd_kernel(a, ct, idx, w2, b2, w3, b3, bn: Sequence[torch.Tensor], packs: Packs,
                        y3_out: Optional[torch.Tensor] = None, staged: bool = False):
    """K6 forward on the card: the same function as `sa_train_fwd_plain` in
    the mode of `packs` (`a` taken unrounded in the bf16 mode: the kernel
    rounds it). Its grids: (y2, y3) f32 in the f32 mode; (h1, h2, mxt) in
    bf16, h1 and h2 with their channels padded to a multiple of 8, out a
    view of mxt[0]. `y3_out` (bf16 mode; (B, S, K, C3) f32): where the max
    pass writes the y3 it took the maxima on, for a check that holds the
    plain backward (its `y3`) to the kernel's maxima and ties. `staged`: the
    staged entries, with the statistics summed over the process group
    between the stages (`_run_staged`; in a world of one the single call's
    results, bit for bit). At widths that are not a multiple of 4 the
    grids keep the padded widths (`_padded_call`)."""
    B, N, C1 = a.shape
    S, K = idx.shape[1], idx.shape[2]
    C2, C3 = w2.shape[1], w3.shape[1]
    dev = a.device
    if (C1 | C2 | C3) % 4:
        P, w2p, b2p, w3p, b3p, bnp, packs_p = _padded_call((C1, C2, C3), w2, b2, w3, b3, bn, packs)
        y3p = None if y3_out is None else torch.empty(B, S, K, P[2], device=dev)
        out, stats, grids = sa_train_fwd_kernel(pad_to(a, P[0]), pad_to(ct, P[0]), idx, w2p, b2p,
                                                w3p, b3p, bnp, packs_p, y3_out=y3p, staged=staged)
        if y3_out is not None:
            y3_out.copy_(y3p[..., :C3])
        stats = tuple(s[:c] for s, c in zip(stats, (C1, C1, C2, C2, C3, C3)))
        return out[..., :C3].contiguous(), stats, grids
    check("a", a, dev, (B, N, C1))
    check("ct", ct, dev, (B, S, C1))
    check("idx", idx, dev, (B, S, K), dtype=torch.int32)
    for name, t, shape in (("w2", w2, (C1, C2)), ("b2", b2, (C2,)), ("w3", w3, (C2, C3)),
                           ("b3", b3, (C3,))):
        check(name, t, dev, shape)
    bn_flat = torch.cat([p.reshape(-1) for p in bn])
    check("bn", bn_flat, dev, (2 * (C1 + C2 + C3),))
    dims = _dims(idx, N, C1, C2, C3)
    bf16 = packs.bf16
    if y3_out is not None:
        if not bf16:
            raise ValueError("y3_out is the bf16 mode's (the f32 mode keeps y3 among its grids)")
        check("y3_out", y3_out, dev, (B, S, K, C3))
    packs.check(("W2", packs.w2, C1, C2), ("W3", packs.w3, C2, C3))
    stats = torch.empty(2 * (C1 + C2 + C3), device=dev)
    ws = _workspace(dims, False, bf16, dev)
    if bf16:
        h1, h2 = (torch.empty(B, S, K, _round8(c), dtype=BF16, device=dev) for c in (C1, C2))
        mxt = torch.empty(3, B, S, C3, device=dev)
        name = "sa_train_bf16_fwd"
        args = (a.data_ptr(), ct.data_ptr(), idx.data_ptr(), packs.w2.data_ptr(), b2.data_ptr(),
                packs.w3.data_ptr(), b3.data_ptr(), bn_flat.data_ptr(), h1.data_ptr(),
                h2.data_ptr(), mxt.data_ptr(), None if y3_out is None else y3_out.data_ptr(),
                stats.data_ptr(), ws.data_ptr(), *dims)
        out, grids = mxt[0], (h1, h2, mxt)
    else:
        grids = tuple(torch.empty(B, S, K, c, device=dev) for c in (C2, C3))
        out = torch.empty(B, S, C3, device=dev)
        name = "sa_train_fwd"
        args = (a.data_ptr(), ct.data_ptr(), idx.data_ptr(), packs.w2.data_ptr(),
                packs.w2.numel(), b2.data_ptr(), packs.w3.data_ptr(), packs.w3.numel(),
                b3.data_ptr(), bn_flat.data_ptr(), grids[0].data_ptr(), grids[1].data_ptr(),
                out.data_ptr(), stats.data_ptr(), ws.data_ptr(), *dims)
    _launch_entry(name, bf16, args, staged, (C1, C2, C3), B * S * K, a)
    fused_sa_train_apply.staged_fwd_launches += int(staged)
    fused_sa_train_apply.fwd_launches += 1
    fused_sa_train_apply.bf16_fwd_launches += int(bf16)
    return out, tuple(torch.split(stats, [C1, C1, C2, C2, C3, C3])), grids


def sa_train_bwd_kernel(g_out, a, ct, idx, grids, stats: Stats, w2, b2, w3, b3,
                        bn: Sequence[torch.Tensor], packs: Packs, staged: bool = False):
    """K6 backward on the card: the same function as `sa_train_bwd_plain` in
    the mode of `packs`, from the grids of `sa_train_fwd_kernel` in that mode.
    Under `torch.use_deterministic_algorithms(True)` da is summed in a fixed
    order (the entries' `ordered` path), else by float atomics. `staged` as
    in `sa_train_fwd_kernel`: the BN backward's sums summed over the process
    group, dgamma and dbeta this rank's own. At widths that are not a
    multiple of 4 the grids are the forward's padded ones."""
    B, N, C1 = a.shape
    S, K = idx.shape[1], idx.shape[2]
    C2, C3 = w2.shape[1], w3.shape[1]
    dev = a.device
    bf16 = packs.bf16
    if (C1 | C2 | C3) % 4:
        P, w2p, b2p, w3p, b3p, bnp, packs_p = _padded_call((C1, C2, C3), w2, b2, w3, b3, bn, packs)
        stats_p = [pad_to(s, P[i // 2]) for i, s in enumerate(stats)]
        da, dct, dw2, dw3, dbn = sa_train_bwd_kernel(
            pad_to(g_out, P[2]), pad_to(a, P[0]), pad_to(ct, P[0]), idx, grids, stats_p,
            w2p, b2p, w3p, b3p, bnp, packs_p, staged=staged)
        return (da[..., :C1].contiguous(), dct[..., :C1].contiguous(),
                dw2[:C1, :C2].contiguous(), dw3[:C2, :C3].contiguous(),
                tuple(d[:c] for d, c in zip(dbn, (C1, C1, C2, C2, C3, C3))))
    check("g_out", g_out, dev, (B, S, C3))
    check("a", a, dev, (B, N, C1))
    check("ct", ct, dev, (B, S, C1))
    check("idx", idx, dev, (B, S, K), dtype=torch.int32)
    if bf16:
        if len(grids) != 3:
            raise ValueError("K6's bf16 backward takes its kernel forward's grids (h1, h2, mxt)")
        h1, h2, mxt = grids[:3]
        for name, t, c in (("h1", h1, C1), ("h2", h2, C2)):
            check(name, t, dev, (B, S, K, _round8(c)), dtype=BF16)
        check("mxt", mxt, dev, (3, B, S, C3))
    else:
        y2, y3 = grids
        for name, t, c in (("y2", y2, C2), ("y3", y3, C3)):
            check(name, t, dev, (B, S, K, c))
    for name, t, shape in (("w2", w2, (C1, C2)), ("b2", b2, (C2,)), ("w3", w3, (C2, C3)),
                           ("b3", b3, (C3,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    stats_flat = torch.cat([s.reshape(-1) for s in stats])
    bn_flat = torch.cat([p.reshape(-1) for p in bn])
    check("stats", stats_flat, dev, (2 * (C1 + C2 + C3),))
    check("bn", bn_flat, dev, (2 * (C1 + C2 + C3),))
    dims = _dims(idx, N, C1, C2, C3)
    packs.check(("W2^T", packs.w2t, C2, C1), ("W3^T", packs.w3t, C3, C2))
    da = torch.empty(B, N, C1, device=dev)
    dct = torch.empty(B, S, C1, device=dev)
    dw2 = torch.empty(C1, C2, device=dev)
    dw3 = torch.empty(C2, C3, device=dev)
    dbn = torch.empty(2 * (C1 + C2 + C3), device=dev)
    ws = _workspace(dims, True, bf16, dev)
    # read at each call, so a captured graph keeps the path it was captured with
    ordered = torch.are_deterministic_algorithms_enabled()
    if bf16:
        b2, b3 = b2.detach().float().contiguous(), b3.detach().float().contiguous()
        check("b2", b2, dev, (C2,))
        check("b3", b3, dev, (C3,))
        name = "sa_train_bf16_bwd"
        args = (g_out.data_ptr(), a.data_ptr(), ct.data_ptr(), idx.data_ptr(), h1.data_ptr(),
                h2.data_ptr(), mxt.data_ptr(), stats_flat.data_ptr(), packs.w2.data_ptr(),
                packs.w3.data_ptr(), packs.w2t.data_ptr(), packs.w3t.data_ptr(), b2.data_ptr(),
                b3.data_ptr(), bn_flat.data_ptr(), da.data_ptr(), dct.data_ptr(), dw2.data_ptr(),
                dw3.data_ptr(), dbn.data_ptr(), ws.data_ptr(), *dims, int(ordered))
    else:
        name = "sa_train_bwd"
        args = (g_out.data_ptr(), a.data_ptr(), ct.data_ptr(), idx.data_ptr(), y2.data_ptr(),
                y3.data_ptr(), stats_flat.data_ptr(), packs.w2t.data_ptr(), packs.w2t.numel(),
                packs.w3t.data_ptr(), packs.w3t.numel(), bn_flat.data_ptr(), da.data_ptr(),
                dct.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), dbn.data_ptr(), ws.data_ptr(),
                *dims, int(ordered))
    _launch_entry(name, bf16, args, staged, (C3, C2, C1), B * S * K, g_out)
    fused_sa_train_apply.staged_bwd_launches += int(staged)
    fused_sa_train_apply.bwd_launches += 1
    fused_sa_train_apply.bf16_bwd_launches += int(bf16)
    fused_sa_train_apply.ordered_bwd_launches += int(ordered)
    return da, dct, dw2, dw3, tuple(torch.split(dbn, [C1, C1, C2, C2, C3, C3]))


def _launch_entry(name: str, bf16: bool, args: tuple, staged: bool, widths, rows: int,
                  like: torch.Tensor) -> None:
    """One K6 entry on `like`'s stream: the single call, or its staged twin
    (`<name>_staged`) stage by stage (`_run_staged`)."""
    lib, stream = _library(bf16), stream_of(like)
    if not staged:
        raise_on(getattr(lib, name)(*args, stream), f"K6 {name}", _ERRORS)
        return
    entry = getattr(lib, name + "_staged")

    def call(stage: int, sums: int) -> None:
        raise_on(entry(*args, stage, sums, stream), f"K6 {name}_staged (stage {stage})", _ERRORS)

    _run_staged(call, widths, rows, like.device)


class _SATrainFunction(torch.autograd.Function):
    """(a, ct, w2, b2, w3, b3, g1, bt1, g2, bt2, g3, bt3, idx, bf16, packs) ->
    (out, *stats); the stats carry no gradient. In the bf16 mode `a` is
    rounded to bf16 (on the plain path here, by the kernel on the card), and
    its gradient passes the rounding unchanged, as JAX's custom VJP passes it.
    Inside `distributed.global_batch()` the statistics are the process
    group's: the kernels run staged, the plain versions with `global_stats`."""

    @staticmethod
    def forward(ctx, a, ct, w2, b2, w3, b3, g1, bt1, g2, bt2, g3, bt3, idx, bf16, packs):
        bn = (g1, bt1, g2, bt2, g3, bt3)
        glob = distributed.in_global_batch()
        if on_cuda(a):
            if packs is None or packs.bf16 != bf16:
                raise ValueError("K6 on the card takes the layer's packed weights of its mode")
            out, stats, grids = sa_train_fwd_kernel(a, ct, idx, w2.contiguous(), b2,
                                                    w3.contiguous(), b3, bn, packs, staged=glob)
        else:
            if bf16:
                a = a.to(BF16).to(a.dtype)
            out, stats, grids = sa_train_fwd_plain(a, ct, idx, w2, b2, w3, b3, bn, bf16, glob)
        ctx.save_for_backward(a, ct, idx, w2, b2, w3, b3, *bn)
        ctx.grids, ctx.stats, ctx.bf16, ctx.packs = grids, stats, bf16, packs
        ctx.glob = glob
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g_out, *_):
        a, ct, idx, w2, b2, w3, b3, *bn = ctx.saved_tensors
        g_out = g_out.contiguous()
        if on_cuda(g_out):
            da, dct, dw2, dw3, dbn = sa_train_bwd_kernel(g_out, a, ct, idx, ctx.grids, ctx.stats,
                                                         w2, b2, w3, b3, bn, ctx.packs,
                                                         staged=ctx.glob)
        else:
            da, dct, dw2, dw3, dbn = sa_train_bwd_plain(g_out, a, ct, idx, ctx.grids, ctx.stats,
                                                        w2, b2, w3, b3, bn, ctx.bf16,
                                                        global_stats=ctx.glob)
        # the Dense biases feeding a BatchNorm: exactly 0
        db2, db3 = w2.new_zeros(w2.shape[1]), w3.new_zeros(w3.shape[1])
        return (da, dct, dw2, db2, dw3, db3, *dbn, None, None, None)


def fused_sa_train_apply(xyz: torch.Tensor, features: Optional[torch.Tensor],
                         new_xyz: torch.Tensor, idx: torch.Tensor, mlp: nn.Module, *,
                         radius: float, normalize_xyz: bool, use_xyz: bool,
                         packs: Optional[Packs] = None
                         ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """K6: xyz (B, N, 3), features (B, N, C) or None, new_xyz (B, S, 3), idx
    (B, S, K) int32 ball-query indices, mlp the SA's 3-layer `mlp_shared`
    (models/layers.py::MLP) -> (out (B, S, C3), [(batch mean, batch var)]
    of each layer). Differentiable in the MLP's parameters, xyz, features and
    new_xyz. The mode is the MLP's: in bf16 (its layers' `dtype`) out is
    bf16, and bf16 features are taken as f32 (JAX's a_form casts them).
    `packs`: the MLP's W2, W3 as `Packs` of its mode, which the kernel needs
    on the card (unused on the CPU)."""
    layers = list(mlp.children())
    if len(layers) != 3:
        raise ValueError(f"the fused training SA takes 3 layers, got {len(layers)}")
    if tuple(idx.shape[:2]) != (xyz.shape[0], new_xyz.shape[1]):
        raise ValueError(f"idx must be (B, S, K), got {tuple(idx.shape)}")
    bf16 = is_bf16(getattr(layers[0], "dtype", None))
    dense = [layer.dense for layer in layers]
    bns = [layer.bn for layer in layers]
    inv_r = 1.0 / radius if normalize_xyz else 1.0
    if features is not None and features.dtype == BF16:
        features = features.to(xyz.dtype)
    a, ct = a_form(xyz, features, new_xyz, dense[0].weight.t(), dense[0].bias, inv_r=inv_r,
                   use_xyz=use_xyz)
    w2, w3 = dense[1].weight.t(), dense[2].weight.t()
    out, *stats = _SATrainFunction.apply(
        a, ct, w2, dense[1].bias, w3, dense[2].bias,
        bns[0].weight, bns[0].bias, bns[1].weight, bns[1].bias, bns[2].weight, bns[2].bias,
        idx.int().contiguous(), bf16, packs)
    if bf16:
        out = out.to(BF16)
    return out, [(stats[2 * i], stats[2 * i + 1]) for i in range(3)]


# launches of either mode, and of the bf16 mode alone
fused_sa_train_apply.fwd_launches = 0
fused_sa_train_apply.bwd_launches = 0
fused_sa_train_apply.bf16_fwd_launches = 0
fused_sa_train_apply.bf16_bwd_launches = 0
# backward launches that summed da in a fixed order (deterministic algorithms)
fused_sa_train_apply.ordered_bwd_launches = 0
# launches of the staged entries (process-group statistics)
fused_sa_train_apply.staged_fwd_launches = 0
fused_sa_train_apply.staged_bwd_launches = 0


def reset_launch_counts() -> None:
    fused_sa_train_apply.fwd_launches = 0
    fused_sa_train_apply.bwd_launches = 0
    fused_sa_train_apply.bf16_fwd_launches = 0
    fused_sa_train_apply.bf16_bwd_launches = 0
    fused_sa_train_apply.ordered_bwd_launches = 0
    fused_sa_train_apply.staged_fwd_launches = 0
    fused_sa_train_apply.staged_bwd_launches = 0
