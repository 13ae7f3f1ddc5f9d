"""Fused eval-mode set abstraction, port of `open3dsot_tpu/ops/sa_fused.py`
(kernels K4 and K5).

One SA layer of PointNet++ in eval mode: for each centroid, the first K
points within the radius (ball query), their centred xyz (divided by r if
`normalize_xyz`) concatenated with their features, three Dense layers with
eval BatchNorm folded in and ReLU, and the max over the K neighbors.

  K4 `fused_sa_apply(..., idx=None, nsample=K)`: the ball query runs on the
     card too (csrc/sa_fused.cu, 3xTF32, and csrc/sa_fused_bf16.cu, the bf16
     mode; the design notes are there).
  K5 `fused_sa_apply(..., idx=idx)`: the same with precomputed indices.

Both kernels take layer 1 in A-form: only the C1-wide rows A[j] are
gathered, and the centroid enters as ct[s] = b1 - (c * inv_r) W1_xyz, which
the kernel computes. A (`a_rows`) is computed here with torch.matmul, as JAX
computes it in XLA outside the pallas_call. Layers 2-3 run on the tensor
cores in 3xTF32 from weights packed by `pack_sa` (ops/chain_fused.py::
pack_chunks); `FoldedSA` holds the folded layers and their packed form,
built once where SetAbstraction caches its folded weights.

`sa_eval_plain` is the plain PyTorch version: ball query by direct
differences (ops/neighbors.py::ball_query), group, centre, the folded MLP
over the (B, S, K, C) grid, max over K. The wrapper takes it for a CPU
tensor and launches the kernel for a CUDA tensor, or raises. K4 is an
operator (`open3dsot::fused_sa_apply`, registered with
torch.library.custom_op, with a fake implementation for torch.export; see
ops/chain_fused.py), which takes the folded and packed weights as tensor
lists; the wrapper calls it, or launches K4 itself for a CUDA tensor that
is not being traced. K5, which no model calls, is launched directly. Launches are counted in `fused_sa_apply.launches` (K4) and
`fused_sa_apply.idx_launches` (K5).

Layout is channels-last (B, N, C); `folded` is the three (W' (in, out),
b') pairs of a SetAbstraction's `mlp_shared` (models/layers.py::MLP.folded,
which uses ops/chain_fused.py::fold_dense_bn), as a plain sequence or a
`FoldedSA`.

The bf16 compute mode (a `FoldedSA` made with `dtype=torch.bfloat16`; JAX
`fused_sa_apply(dtype=jnp.bfloat16)`): A and ct stay f32 (features
that arrive as bf16 are taken as f32, as JAX's a_form casts them); the
gathered A rows are rounded to bf16, as the compiled TPU kernel gathers
them (the kernel rounds them as it gathers them); then relu(g + ct) in f32,
and layers 2-3 with bf16 operands and f32 sums, from weights packed in bf16
panels (`pack_panels_bf16`); the max over K is returned as bf16.
`sa_eval_plain(..., dtype=)` does the same by rounding, in A-form.

Every shape the JAX kernels take runs on a hand kernel (`_launch`):
  - widths that are not a multiple of 4 run at the widths rounded up to 4:
    the packed weights are the same at both (`pack_chunks` and
    `pack_panels_bf16` pad every width with zeros to whole chunks or panels),
    layer 1's weight and the biases are zero-padded, so each extra channel
    is relu(0 + 0) = 0 into zero weight rows, and the output's extra
    channels are sliced away;
  - K > 64 (a centroid past one 64-row tile), and widths whose tiles do not
    fit in shared memory (the entries' kErrSmem), take the eval rows path
    (`sa_rows_eval` in csrc/sa_fused_train.cu: K6's row products with
    identity folds over the whole (B, S, K) grid in device memory, then the
    max over each centroid's K rows), in both modes; counted in
    `fused_sa_apply.rows_launches` too. Its weights are packed by
    `pack_chunks` (rounded to bf16 first in the bf16 mode), once per
    `FoldedSA` (`rows_packs`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from open3dsot_tpu_torch.ops._launch import (MAX_GRID_Y, batch_slices, check, direct, on_cuda,
                                             raise_on, stream_of)
from open3dsot_tpu_torch.ops.chain_fused import (
    BF16,
    _dense,
    is_bf16,
    pack_chunks,
    pack_panels_bf16,
    pad_to,
    round4,
    round_bf16,
)
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.neighbors import ball_query, radius_sq

Folded = Sequence[Tuple[torch.Tensor, torch.Tensor]]
# how the 3xTF32 K4/K5 gather their rows (csrc/sa_fused.cu::Gather); the bf16
# mode has one form
GATHER_FORMS = ("ldg", "cp_async")

_ERRORS = {-1: "B, N, S, K or widths not accepted",
           -2: "a width C1, C2 or C3 is not a multiple of 4 (the wrapper pads them)",
           -3: "the tiles and the weight stages do not fit in shared memory",
           -4: "a packed weight has the wrong size"}
_ROWS_ERRORS = {-1: "B (up to 65535), S or K not accepted (B * S * K below 2^31 rows)",
                -2: "a width C1, C2 or C3 is not a multiple of 4 (the wrapper pads them)",
                -3: "a packed weight has the wrong size"}
# the most neighbours K4/K5 hold in one 64-row tile (csrc/sa_fused.cu kTile,
# csrc/sa_fused_bf16.cu kRows); more take the rows path
TILE_K = 64
_ERR_SMEM = -3  # the entries' kErrSmem: the tiles do not fit, the rows path takes the shape


class PackedSA(NamedTuple):
    """K4/K5's weights: layer 1's xyz rows (3, C1) and bias, layers 2-3 packed
    for the tensor cores (`pack_chunks`, or `pack_panels_bf16` in the bf16
    mode) with their biases."""
    w1x: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def pack_sa(folded: Folded, dtype=None) -> PackedSA:
    """The packed form of three folded layers for the mode `dtype`, on their device."""
    (w1, b1), (w2, b2), (w3, b3) = folded
    f = lambda t: t.detach().float().contiguous()  # noqa: E731
    pack = pack_panels_bf16 if is_bf16(dtype) else pack_chunks
    return PackedSA(f(w1[:3]), f(b1), pack(f(w2)), f(b2), pack(f(w3)), f(b3))


class FoldedSA(tuple):
    """The folded (W' (in, out), b') layers of an SA MLP, a tuple of pairs as
    `sa_eval_plain` takes them, with `packed` = `pack_sa` of them for the mode
    `dtype` (None: 3xTF32, torch.bfloat16: bf16) when there are three and they
    lie on a CUDA device (else None)."""

    def __new__(cls, layers, dtype=None):
        return super().__new__(cls, (tuple(layer) for layer in layers))

    def __init__(self, layers, dtype=None):
        super().__init__()
        self.dtype = BF16 if is_bf16(dtype) else None
        packed = len(self) == 3 and self[0][0].is_cuda
        self.packed = pack_sa(self, self.dtype) if packed else None

    def tensors(self) -> List[torch.Tensor]:
        """The layers' tensors, then the packed ones, in the order
        `with_tensors` takes them."""
        return [t for layer in self for t in layer] + list(self.packed or ())

    def with_tensors(self, tensors: Sequence[torch.Tensor]) -> "FoldedSA":
        """These layers with their tensors replaced (in `tensors()`'s order),
        not packed again."""
        n = 2 * len(self)
        new = tuple.__new__(FoldedSA, (tuple(tensors[i:i + 2]) for i in range(0, n, 2)))
        new.dtype = self.dtype
        new.packed = None if self.packed is None else PackedSA(*tensors[n:])
        return new


def a_rows(xyz: torch.Tensor, features: Optional[torch.Tensor], w1: torch.Tensor, *,
           inv_r: float, use_xyz: bool) -> torch.Tensor:
    """Layer 1's A over all N points, in as few launches as it takes: (x *
    inv_r) @ W1_xyz (+ f @ W1_feat), or f @ W1 when layer 1 reads no xyz ->
    (B, N, C1). K4/K5 take it alone and compute ct themselves."""
    B, N = xyz.shape[:2]
    if not (use_xyz or features is None):
        return torch.matmul(features, w1)
    x = (xyz if inv_r == 1.0 else xyz * inv_r).reshape(B * N, 3)
    a = torch.mm(x, w1[:3])
    if features is not None:
        a.addmm_(features.reshape(B * N, -1), w1[3:])  # in place: no copy of a
    return a.view(B, N, -1)


def a_form(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
           w1: torch.Tensor, b1: torch.Tensor, *, inv_r: float, use_xyz: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer 1 as A[j] + ct[s] (sa_fused.py::a_form): a = `a_rows`, ct = b1 -
    (c * inv_r) @ W1_xyz. Returns (a (B, N, C1), ct (B, S, C1)), f32."""
    B, S = xyz.shape[0], new_xyz.shape[1]
    ct = b1[None, None, :].expand(B, S, w1.shape[1])
    if use_xyz or features is None:
        ct = ct - torch.matmul(new_xyz * inv_r, w1[:3])
    return a_rows(xyz, features, w1, inv_r=inv_r, use_xyz=use_xyz), ct.contiguous()


def group_inputs(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
                 idx: torch.Tensor, *, radius: float, normalize_xyz: bool, use_xyz: bool
                 ) -> torch.Tensor:
    """The SA MLP's input at each centroid's neighbors idx (B, S, K): centred
    xyz (/radius if normalize_xyz) || grouped features -> (B, S, K, C)."""
    grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]  # (B, S, K, 3)
    if normalize_xyz:
        grouped = grouped / radius
    if features is not None:
        grouped_feats = group_points(features, idx)
        grouped = torch.cat([grouped, grouped_feats], dim=-1) if use_xyz else grouped_feats
    return grouped


def sa_eval_plain(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
                  idx: Optional[torch.Tensor], folded: Folded, *, radius: float,
                  normalize_xyz: bool, use_xyz: bool, nsample: Optional[int] = None,
                  dtype=None) -> torch.Tensor:
    """The plain version of K4/K5: -> (B, S, C3), f32 (bf16 in the bf16 mode,
    which runs layer 1 in A-form with the gathered A rows rounded to bf16, as
    the kernels do)."""
    if idx is None:
        idx = ball_query(radius, nsample, xyz, new_xyz)
    if is_bf16(dtype):
        (w1, b1), (w2, b2), (w3, b3) = folded
        a, ct = a_form(xyz, None if features is None else features.float(), new_xyz, w1, b1,
                       inv_r=1.0 / radius if normalize_xyz else 1.0, use_xyz=use_xyz)
        h = torch.relu(group_points(round_bf16(a), idx) + ct[:, :, None, :])
        h = torch.relu(_dense(h, w2, True) + b2)
        h = torch.relu(_dense(h, w3, True) + b3)
        return h.amax(dim=2).to(BF16)
    grouped = group_inputs(xyz, features, new_xyz, idx, radius=radius,
                           normalize_xyz=normalize_xyz, use_xyz=use_xyz)
    for w, b in folded:
        grouped = torch.relu(grouped @ w + b)
    return grouped.amax(dim=2)


def rows_packs(folded: Folded, bf16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """W2 and W3 as the eval rows path reads them: `pack_chunks`, of the
    weights rounded to bf16 in the bf16 mode; kept on a `FoldedSA` (its
    weights do not change after it is made)."""
    cache = getattr(folded, "_rows_packs", None)
    if cache is not None and cache[0] == bf16:
        return cache[1]
    r = round_bf16 if bf16 else (lambda t: t)
    packs = tuple(pack_chunks(r(w.detach().float().contiguous())) for w, _ in folded[1:])
    if isinstance(folded, FoldedSA):
        folded._rows_packs = (bf16, packs)
    return packs


def _launch_rows(xyz, new_xyz, idx, a, w1x, b1, w2p, b2, w3p, b3, out, *, radius: float,
                 inv_r: float, K: int, bf16: bool) -> None:
    """The eval rows path (csrc/sa_fused_train.cu::sa_rows_eval) into out, at
    widths that are multiples of 4."""
    from open3dsot_tpu_torch.ops._build import load_library

    lib = load_library("sa_fused_train").lib
    B, N, C1 = a.shape
    S, C2, C3 = new_xyz.shape[1], b2.shape[0], b3.shape[0]
    dims = (B, N, S, K, C1, C2, C3)
    nbytes = lib.sa_rows_workspace(*dims)
    raise_on(min(nbytes, 0), "K4/K5 rows path workspace", _ROWS_ERRORS)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=a.device)
    rc = lib.sa_rows_eval(xyz.data_ptr(), new_xyz.data_ptr(),
                          None if idx is None else idx.data_ptr(), a.data_ptr(),
                          None if w1x is None else w1x.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                          w2p.numel(), b2.data_ptr(), w3p.data_ptr(), w3p.numel(), b3.data_ptr(),
                          out.data_ptr(), ws.data_ptr(), *dims, radius_sq(radius), inv_r,
                          int(bf16), stream_of(a))
    raise_on(rc, "K4/K5 sa_rows_eval (the rows path)", _ROWS_ERRORS)
    fused_sa_apply.rows_launches += 1


def _launch(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
            idx: Optional[torch.Tensor], folded: Folded, packed: Optional[PackedSA], *,
            radius: float, normalize_xyz: bool, use_xyz: bool, K: int, gather: int,
            bf16: bool = False) -> torch.Tensor:
    """Check the inputs against the kernel's and launch it: K4 when idx is
    None (K neighbors by its ball query), else K5 (idx (B, S, K) int32); in
    the bf16 mode with `bf16` (packed weights of that mode, output bf16; its
    one gather form takes no `gather`). K > 64 and widths whose tiles do not
    fit run on the rows path, widths not a multiple of 4 padded (the module
    docstring), a batch of more than MAX_GRID_Y clouds a slice at a time."""
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = xyz.shape
    if B > MAX_GRID_Y:  # the batch is the grid's y: a launch a slice of it
        pick = lambda t, b0, b1: None if t is None else t[b0:b1]  # noqa: E731
        return torch.cat([_launch(xyz[b0:b1], pick(features, b0, b1), new_xyz[b0:b1],
                                  pick(idx, b0, b1), folded, packed, radius=radius,
                                  normalize_xyz=normalize_xyz, use_xyz=use_xyz, K=K,
                                  gather=gather, bf16=bf16) for b0, b1 in batch_slices(B)])
    S = new_xyz.shape[1]
    dev = xyz.device
    (w1, b1), (w2, b2), (w3, b3) = folded
    C1, C2, C3 = w1.shape[1], w2.shape[1], w3.shape[1]
    check("xyz", xyz, dev, (B, N, 3))
    check("new_xyz", new_xyz, dev, (B, S, 3))
    if features is not None and features.dtype == BF16:
        features = features.float()  # exact; a_form casts them so in JAX
    if features is not None and (features.device != dev or features.dtype != torch.float32):
        raise TypeError(f"features must be float32 or bfloat16 on {dev} (only a_rows' "
                        "matmul reads them)")
    if idx is not None:
        check("idx", idx, dev, (B, S, K), dtype=torch.int32)
    reads_xyz = use_xyz or features is None
    c_in = 3 * reads_xyz + (0 if features is None else features.shape[2])
    for name, t, shape in (("w1", w1, (c_in, C1)), ("b1", b1, (C1,)), ("w2", w2, (C1, C2)),
                           ("b2", b2, (C2,)), ("w3", w3, (C2, C3)), ("b3", b3, (C3,))):
        check(name, t, dev, shape)
    packed = packed or pack_sa(folded, BF16 if bf16 else None)
    if packed.w2.device != dev:
        raise ValueError(f"the packed weights are on {packed.w2.device}, expected {dev}")
    inv_r = 1.0 / radius if normalize_xyz else 1.0
    # widths padded to multiples of 4: the packs are the same, the rest is zero-padded
    P1, P2, P3 = round4(C1), round4(C2), round4(C3)
    w1x, b1p = pad_to(packed.w1x, P1), pad_to(packed.b1, P1)
    b2p, b3p = pad_to(packed.b2, P2), pad_to(packed.b3, P3)
    a = a_rows(xyz, features, pad_to(w1, P1), inv_r=inv_r, use_xyz=use_xyz)  # f32; bf16 rounds it
    out = torch.empty(B, S, P3, device=dev, dtype=BF16 if bf16 else torch.float32)
    rc = _ERR_SMEM
    if K <= TILE_K:
        idx_ws = torch.empty(B, S, K, dtype=torch.int32, device=dev) if idx is None else None
        args = (xyz.data_ptr(), new_xyz.data_ptr(), None if idx is None else idx.data_ptr(),
                None if idx_ws is None else idx_ws.data_ptr(), a.data_ptr(),
                w1x.data_ptr() if reads_xyz else None, b1p.data_ptr(),
                packed.w2.data_ptr(), packed.w2.numel(), b2p.data_ptr(), packed.w3.data_ptr(),
                packed.w3.numel(), b3p.data_ptr(), out.data_ptr(), B, N, S, K, P1, P2, P3,
                radius_sq(radius), inv_r)
        if bf16:
            entry = load_library("sa_fused_bf16").lib.sa_fused_k4_bf16
            rc = entry(*args, stream_of(xyz))
        else:
            entry = load_library("sa_fused").lib.sa_fused_k4
            rc = entry(*args, gather, stream_of(xyz))
        if rc != _ERR_SMEM:
            raise_on(rc, f"K4 {entry.__name__} (ball query)" if idx is None
                     else f"K5 {entry.__name__} (idx given)", _ERRORS)
    if rc == _ERR_SMEM:  # K past one tile, or tiles that do not fit: the rows path
        w2r, w3r = rows_packs(folded, bf16)
        _launch_rows(xyz, new_xyz, idx, a, w1x if reads_xyz else None, b1p, w2r, b2p, w3r, b3p,
                     out, radius=radius, inv_r=inv_r, K=K, bf16=bf16)
    return out if P3 == C3 else out[..., :C3].contiguous()


def _pairs(layers: Sequence[torch.Tensor]) -> tuple:
    return tuple(tuple(layers[i:i + 2]) for i in range(0, len(layers), 2))


# K4's operator: `layers` the three folded layers flat (w1, b1, w2, b2, w3,
# b3), `packed` their PackedSA (six tensors) or empty; gather -1 is the
# kernel's own choice of gather form; bf16 the mode (the output bf16).
@torch.library.custom_op("open3dsot::fused_sa_apply", mutates_args=(), device_types="cpu")
def _k4_op(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
           layers: List[torch.Tensor], packed: List[torch.Tensor], radius: float,
           normalize_xyz: bool, use_xyz: bool, nsample: int, gather: int,
           bf16: bool = False) -> torch.Tensor:
    """K4 on the CPU: the plain version."""
    return sa_eval_plain(xyz, features, new_xyz, None, _pairs(layers), radius=radius,
                         normalize_xyz=normalize_xyz, use_xyz=use_xyz, nsample=nsample,
                         dtype=BF16 if bf16 else None)


@_k4_op.register_fake
def _k4_fake(xyz, features, new_xyz, layers, packed, radius, normalize_xyz, use_xyz, nsample,
             gather, bf16=False):
    return new_xyz.new_empty(new_xyz.shape[0], new_xyz.shape[1], layers[4].shape[1],
                             dtype=BF16 if bf16 else torch.float32)


@_k4_op.register_kernel("cuda")
def _k4_cuda(xyz, features, new_xyz, layers, packed, radius, normalize_xyz, use_xyz, nsample,
             gather, bf16=False):
    out = _launch(xyz, features, new_xyz, None, _pairs(layers),
                  PackedSA(*packed) if packed else None, radius=radius,
                  normalize_xyz=normalize_xyz, use_xyz=use_xyz, K=nsample, gather=gather,
                  bf16=bf16)
    fused_sa_apply.launches += 1
    return out


def fused_sa_apply(xyz: torch.Tensor, features: Optional[torch.Tensor], new_xyz: torch.Tensor,
                   idx: Optional[torch.Tensor], folded: Folded, *, radius: float,
                   normalize_xyz: bool, use_xyz: bool, nsample: Optional[int] = None,
                   gather: Optional[str] = None) -> torch.Tensor:
    """K4 (idx None, pass nsample) or K5 (idx (B, S, K) int32): xyz (B, N, 3),
    features (B, N, C) or None, new_xyz (B, S, 3) centroids -> (B, S, C3).
    gather: one of GATHER_FORMS to force the 3xTF32 kernel's gather form (to
    time them), or None for the kernel's own choice. The compute mode is the
    folded layers' own (`FoldedSA.dtype`; plain pairs are f32): bf16 gives a
    bf16 output, and has one gather form."""
    if len(folded) != 3:
        raise ValueError(f"the fused SA takes 3 folded layers, got {len(folded)}")
    if idx is None and nsample is None:
        raise ValueError("nsample is required when idx is None")
    if gather is not None and gather not in GATHER_FORMS:
        raise ValueError(f"gather must be None or one of {GATHER_FORMS}, got {gather!r}")
    B = xyz.shape[0]
    S = new_xyz.shape[1]
    if idx is not None and tuple(idx.shape[:2]) != (B, S):
        raise ValueError(f"idx must be ({B}, {S}, K), got {tuple(idx.shape)}")
    cuda = on_cuda(xyz)  # a device with neither a kernel nor a plain version raises
    gather_form = -1 if gather is None else GATHER_FORMS.index(gather)
    kw = dict(radius=radius, normalize_xyz=normalize_xyz, use_xyz=use_xyz)
    bf16 = is_bf16(getattr(folded, "dtype", None))
    if bf16 and gather is not None:
        raise ValueError("the bf16 mode has one gather form: gather must be None")
    packed = getattr(folded, "packed", None)
    if idx is None and not direct(xyz):
        return _k4_op(xyz, features, new_xyz, [t for layer in folded for t in layer],
                      list(packed or ()), nsample=int(nsample), gather=gather_form, bf16=bf16,
                      **kw)
    if not cuda:
        return sa_eval_plain(xyz, features, new_xyz, idx, folded, dtype=BF16 if bf16 else None,
                             **kw)
    K = int(nsample) if idx is None else idx.shape[2]
    out = _launch(xyz, features, new_xyz, idx, folded, packed, K=K, gather=gather_form,
                  bf16=bf16, **kw)
    if idx is None:
        fused_sa_apply.launches += 1
    else:
        fused_sa_apply.idx_launches += 1
    return out


fused_sa_apply.launches = 0
fused_sa_apply.idx_launches = 0
fused_sa_apply.rows_launches = 0  # of either, on the rows path (K > 64, or wide tiles)


def reset_launch_counts() -> None:
    fused_sa_apply.launches = 0
    fused_sa_apply.idx_launches = 0
    fused_sa_apply.rows_launches = 0
