"""Fused eval-mode PointNet chains (SegPointNet / MiniPointNet), port of
`open3dsot_tpu/ops/chain_fused.py`.

Two kernels, CUDA C++ in `csrc/chain_fused.cu` (3xTF32) and
`csrc/chain_fused_bf16.cu` (the bf16 mode); the design notes are there:

  K1 `fused_pointnet_encoder`: per point, a chain of Dense layers with eval
     BatchNorm folded in, each followed by ReLU; optionally one layer is
     written out as a tap; the last layer is max-pooled over the points.
  K2 `fused_seg_head`: concat(tap, broadcast(pooled)) -> folded chain with
     ReLU -> plain head Dense -> per-point logits.

Each kernel is an operator (`open3dsot::fused_pointnet_encoder`,
`open3dsot::fused_seg_head`, registered with torch.library.custom_op): the
plain PyTorch version (`pointnet_encoder_plain`, `seg_head_plain`) for a
tensor on the CPU, the kernel for a tensor on a CUDA device, which raises if
it cannot build or launch; nothing falls back. The operators take tensors
and ints, not a `FoldedChain`, and have fake implementations that give
their outputs' shapes, so that torch.export traces a step through them (the
launch reads data pointers, which a traced tensor has none of) and a loaded
program calls them again (tracking/serving_export.py). A wrapper calls its
operator for a CPU tensor or a traced one, and the operator's CUDA function
directly for a CUDA tensor (`_launch.direct`), which spares the eager paths
the dispatch. Each wrapper counts its kernel launches in a plain integer
attribute, `<wrapper>.launches`.

Widths the kernels read as padded rows: a tap width (K1) or a first width
of K2 that is not a multiple of 8 runs at that width rounded up to 8. The
packed weights are the same at both widths (`pack_layer` pads every width
to whole chunks with zeros), the extra channels come out as relu(0 + 0) = 0
and are sliced away (K1's tap), and K2's W_pool is zero-padded to match
(`_padded_widths`). The batch is the kernels' grid.y: a batch of more than
MAX_GRID_Y (65535) clouds runs a slice at a time.

Layout is channels-last (B, N, C) at every function, as in the JAX package.
Folded weights are (in, out) float32, as `fold_dense_bn` gives them; the
kernels take them packed by `FoldedChain`: transposed to (out, in),
zero-padded to whole weight chunks and split into TF32 hi and lo parts for
the 3xTF32 tensor-core products.

The bf16 compute mode (`FoldedChain(..., dtype=torch.bfloat16)`, the JAX
kernels' `dtype=jnp.bfloat16`): BatchNorm folds in f32 as in the f32 mode;
each layer's product takes bf16 operands (the activations and W' rounded to
nearest even) and accumulates in f32, then + b' (f32) and ReLU. The tap, the
pooled vector and K2's logits stay f32. The weights are packed in bf16
panels (`pack_panels_bf16`) for `chain_fused_k1_bf16` / `_k2_bf16`; the plain
versions round the operands and multiply in f32 (`_dense`), which is exact
bf16-operand / f32-accumulate arithmetic on the CPU and the card alike (TF32
off).
"""

from __future__ import annotations

import copy
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from open3dsot_tpu_torch.ops._launch import (MAX_GRID_Y, batch_slices, check, direct, on_cuda,
                                             raise_on, stream_of)

BN_EPS = 1e-5  # models/layers.py::DenseBNRelu epsilon, as on the JAX side

BF16 = torch.bfloat16

# Tolerance of the kernels against f32: |k - ref| <= TOL * max|ref| + TOL * |ref|.
# 3xTF32 drops a_lo * w_lo, about 2^-22 of each product, and the tensor
# cores accumulate in f32 in another order than cuBLAS: an error of order
# 1e-6 relative over the chains' five layers (the CPU emulation of the
# kernel's arithmetic in tests/test_torch_chain_fused.py stays within this
# bound of float64, while TF32 alone does not). chip_smoke.py holds the
# kernels to their plain f32 versions with it.
TOL_3XTF32 = 1e-4

_ERRORS = {-1: "layer count, widths or packed size not accepted",
           -2: "the tap width or K2's first width is not a multiple of 8 (the wrappers pad them)",
           -3: "a layer does not fit in shared memory",
           -4: "workspace smaller than the plan needs"}


def fold_dense_bn(weight: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                  beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding Dense (f32, eps 1e-5).

    weight is a torch Linear weight (out, in). Returns (W' (in, out), b') with
    relu(x @ W' + b') == relu(BN_eval(x @ weight.T + bias))
    (open3dsot_tpu/ops/sa_fused.py::fold_dense_bn).
    """
    g = scale.float() * torch.rsqrt(var.float() + BN_EPS)
    w = (weight.float().t() * g[None, :]).contiguous()
    return w, (bias.float() - mean.float()) * g + beta.float()


def round8(n: int) -> int:
    return -(-n // 8) * 8


def round4(n: int) -> int:
    return -(-n // 4) * 4


def pad_to(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """t zero-padded at the end of its last len(sizes) dims to `sizes` (the
    wrappers' padded widths); t itself where it has them."""
    pads = []
    for dim, n in zip(range(t.dim() - 1, t.dim() - 1 - len(sizes), -1), reversed(sizes)):
        pads += [0, n - t.shape[dim]]
    return F.pad(t, pads) if any(pads) else t


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits; the low 13 bits zero), to
    nearest with ties away from zero, as PTX `cvt.rna.tf32.f32` rounds."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(t), lo = tf32(t - hi): the 3xTF32 operands."""
    hi = tf32_rna(t)
    return hi, tf32_rna(t.float() - hi)


def is_bf16(dtype) -> bool:
    """Whether a compute dtype is the bf16 mode (None and float32 are f32)."""
    if dtype not in (None, torch.float32, BF16):
        raise ValueError(f"compute dtype must be None, float32 or bfloat16, got {dtype}")
    return dtype is BF16


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), as f32."""
    return t.to(BF16).float()


def _dense(h: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """h @ w; in the bf16 mode with both rounded to bf16 and the sums in f32."""
    if bf16:
        return round_bf16(h) @ round_bf16(w)
    return h @ w


# The tensor cores' weight chunk: output x input channels (csrc/tf32_tc.cuh kCC, kKC)
CHUNK_OUT, CHUNK_IN = 128, 32


def _padded_t(w: torch.Tensor):
    """W^T (out, in) zero-padded to whole chunks, and the chunk counts."""
    k, c = w.shape
    nc, nk = -(-round8(c) // CHUNK_OUT), -(-round8(k) // CHUNK_IN)
    wt = w.new_zeros(nc * CHUNK_OUT, nk * CHUNK_IN)
    wt[:c, :k] = w.t()
    return wt, nc, nk


def pack_chunks(w: torch.Tensor) -> torch.Tensor:
    """A weight w (in, out) as the tensor cores read it (csrc/tf32_tc.cuh).
    W^T (out, in) is zero-padded to whole chunks of CHUNK_OUT x CHUNK_IN
    channels; the chunks follow each other output-chunk major, each W^T hi
    then W^T lo, each part in "core matrices" of 8 outputs x 4 inputs (128
    bytes), input-major within the chunk, as the tensor cores read B from
    shared memory."""
    wt, nc, nk = _padded_t(w)
    parts = [p.reshape(nc, CHUNK_OUT // 8, 8, nk, CHUNK_IN // 4, 4).permute(0, 3, 1, 4, 2, 5)
             for p in split_tf32(wt)]
    chunks = torch.stack(parts, dim=2)  # (out chunk, in chunk, hi/lo, 8s of out, 4s of in, 8, 4)
    return chunks.reshape(-1)


# The bf16 kernels' weight panel: a layer's output chunk (64 channels where the
# layer has at most 64, else 128) x PANEL_K inputs (csrc/bf16_layers.cuh)
PANEL_K = 64


def panel_width(c: int) -> int:
    """Output channels of a bf16 panel of a layer with c outputs
    (csrc/bf16_layers.cuh::chunk_width)."""
    return 128 if c > 64 else 64


def pack_panels_bf16(w: torch.Tensor) -> torch.Tensor:
    """A weight w (in, out) as the bf16 kernels read it (csrc/bf16_layers.cuh):
    W^T (out, in) rounded to bf16 and zero-padded to whole panels of
    panel_width(out) x PANEL_K channels; the panels follow each other
    output-chunk major, each in core matrices of 8 outputs x 8 inputs (128
    bytes), input-major within the panel. Returned as the float32 view of
    those bf16 values (half as many floats), so that a layer's weights and
    bias share one f32 buffer."""
    k, c = w.shape
    pw = panel_width(c)
    nc, nk = -(-c // pw), -(-k // PANEL_K)
    wt = w.new_zeros(nc * pw, nk * PANEL_K)
    wt[:c, :k] = w.t()
    panels = wt.to(BF16).reshape(nc, pw // 8, 8, nk, PANEL_K // 8, 8)
    return panels.permute(0, 3, 1, 4, 2, 5).contiguous().reshape(-1).view(torch.float32)


def pack_layer(w: torch.Tensor, b: torch.Tensor, dtype=None) -> torch.Tensor:
    """One layer as K1/K2 read it: `pack_chunks(w)` (`pack_panels_bf16` in the
    bf16 mode), then b (f32) zero-padded to a multiple of 8."""
    c = w.shape[1]
    packed = pack_panels_bf16(w) if is_bf16(dtype) else pack_chunks(w)
    return torch.cat([packed, F.pad(b.float(), (0, round8(c) - c))])


class FoldedChain:
    """A chain of Dense layers, weights (in, out) and biases, ready for K1/K2.

    `split` > 0 marks K2's first layer, whose input is concat(tap, pooled):
    its first `split` rows (W_tap) go into the packed buffer and the rest
    (W_pool, f32 (in, out)) into `w_pool`. The packed buffer holds each
    layer as `pack_layer` lays it out for `dtype` (None: the 3xTF32 mode,
    read by `csrc/chain_fused.cu`; torch.bfloat16: the bf16 mode, read by
    `csrc/chain_fused_bf16.cu`). The weights and biases themselves stay f32 in
    both modes.
    """

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], split: int = 0,
                 dtype=None):
        self.weights = [w.detach().float().contiguous() for w, _ in layers]
        self.biases = [b.detach().float().contiguous() for _, b in layers]
        self.widths = [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]
        self.split = split
        self.dtype = BF16 if is_bf16(dtype) else None
        first = self.weights[0][:split] if split else self.weights[0]
        self.w_pool = self.weights[0][split:].contiguous() if split else None
        self.packed = torch.cat([pack_layer(w, b, self.dtype) for w, b in
                                 zip([first] + self.weights[1:], self.biases)])
        self.packed_widths = [first.shape[0]] + self.widths[1:]

    @property
    def layers(self):
        return list(zip(self.weights, self.biases))

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor the kernels and the plain versions read, in the order
        `with_tensors` takes them."""
        return [*self.weights, *self.biases, self.packed] + ([self.w_pool] if self.split else [])

    def with_tensors(self, tensors: Sequence[torch.Tensor]) -> "FoldedChain":
        """This chain with its tensors replaced (in `tensors()`'s order), not
        packed again."""
        new, n = copy.copy(self), len(self.weights)
        new.weights, new.biases = list(tensors[:n]), list(tensors[n:2 * n])
        new.packed = tensors[2 * n]
        new.w_pool = tensors[2 * n + 1] if self.split else None
        return new


# --- plain versions -------------------------------------------------------

def _encoder_layers(x: torch.Tensor, layers, tap_at: Optional[int], bf16: bool = False):
    h, tap = x, None
    for i, (w, b) in enumerate(layers):
        h = torch.relu(_dense(h, w, bf16) + b)
        if i == tap_at:
            tap = h
    return tap, h.amax(dim=1)


def _seg_head_layers(tap: torch.Tensor, pooled: torch.Tensor, layers,
                     bf16: bool = False) -> torch.Tensor:
    B, N, _ = tap.shape
    h = torch.cat([tap, pooled[:, None, :].expand(B, N, pooled.shape[1])], dim=-1)
    for w, b in layers[:-1]:
        h = torch.relu(_dense(h, w, bf16) + b)
    w, b = layers[-1]
    return _dense(h, w, bf16) + b


def pointnet_encoder_plain(x: torch.Tensor, chain: FoldedChain,
                           tap_at: Optional[int] = None
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """x (B, N, C) -> (tap (B, N, C_tap) or None, pooled (B, C_last)), f32 in
    both modes (chain.dtype)."""
    return _encoder_layers(x, chain.layers, tap_at, is_bf16(chain.dtype))


def seg_head_plain(tap: torch.Tensor, pooled: torch.Tensor, chain: FoldedChain) -> torch.Tensor:
    """tap (B, N, C_tap), pooled (B, C_pool) -> (B, N, C_out) f32; last layer plain."""
    return _seg_head_layers(tap, pooled, chain.layers, is_bf16(chain.dtype))


# --- the kernels' operators -----------------------------------------------
# `widths` are a FoldedChain's `packed_widths`; tap_at -1 means no tap, and
# K1 then returns a (B, N, 0) tap; `bf16` the chain's mode (its packing).
# Every output is f32 in both modes.

def _c_widths(widths: Sequence[int]):
    return (ctypes.c_int * len(widths))(*widths), len(widths) - 1


def _library(bf16: bool):
    """The library of a mode and its entries (workspace, K1, K2)."""
    from open3dsot_tpu_torch.ops._build import load_library

    if bf16:
        lib = load_library("chain_fused_bf16").lib
        return lib.chain_fused_bf16_workspace, lib.chain_fused_k1_bf16, lib.chain_fused_k2_bf16
    lib = load_library("chain_fused").lib
    return lib.chain_fused_workspace, lib.chain_fused_k1, lib.chain_fused_k2


def _workspace(workspace, widths, n_layers: int, B: int, N: int, dev, what: str):
    """Device memory between the kernels' launches, as the C side plans them."""
    n = workspace(widths, n_layers, B, N)
    if n < 0:
        raise_on(n, what, _ERRORS)
    return torch.empty(max(n, 1), device=dev), n


def _padded_widths(widths: Sequence[int], at: int) -> List[int]:
    """`widths` with widths[at] rounded up to a multiple of 8, as the kernels
    read the tap (K1) and K2's first layer output: the packed weights are the
    same at both widths, so only the entries' widths change."""
    out = list(widths)
    out[at] = round8(out[at])
    return out


@torch.library.custom_op("open3dsot::fused_pointnet_encoder", mutates_args=(),
                         device_types="cpu")
def _k1_op(x: torch.Tensor, packed: torch.Tensor, weights: List[torch.Tensor],
           biases: List[torch.Tensor], widths: List[int], tap_at: int, bf16: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the CPU: the plain version."""
    tap, pooled = _encoder_layers(x, list(zip(weights, biases)), tap_at, bf16)
    return (x.new_empty(x.shape[0], x.shape[1], 0) if tap is None else tap), pooled


@_k1_op.register_fake
def _k1_fake(x, packed, weights, biases, widths, tap_at, bf16=False):
    B, N, _ = x.shape
    return x.new_empty(B, N, widths[tap_at + 1] if tap_at >= 0 else 0), x.new_empty(B, widths[-1])


@_k1_op.register_kernel("cuda")
def _k1_cuda(x, packed, weights, biases, widths, tap_at, bf16=False):
    B, N, _ = x.shape
    if B > MAX_GRID_Y:  # the batch is the grid's y: a launch a slice of it
        parts = [_k1_cuda(x[b0:b1], packed, weights, biases, widths, tap_at, bf16)
                 for b0, b1 in batch_slices(B)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = x.device
    check("x", x, dev)
    check("packed weights", packed, dev)
    c_tap = widths[tap_at + 1] if tap_at >= 0 else 0
    if c_tap % 8:  # the kernels write the tap at its padded width
        widths = _padded_widths(widths, tap_at + 1)
    tap = torch.empty(B, N, round8(c_tap), device=dev)
    pooled = torch.empty(B, widths[-1], device=dev)
    c_widths, n_layers = _c_widths(widths)
    workspace, k1, _ = _library(bf16)
    what = f"K1 {k1.__name__}"
    ws, ws_n = _workspace(workspace, c_widths, n_layers, B, N, dev, what)
    rc = k1(x.data_ptr(), packed.data_ptr(), packed.numel(), c_widths, n_layers, B, N, tap_at,
            tap.data_ptr() if tap_at >= 0 else None, pooled.data_ptr(), ws.data_ptr(), ws_n,
            stream_of(x))
    raise_on(rc, what, _ERRORS)
    fused_pointnet_encoder.launches += 1
    return (tap[..., :c_tap].contiguous() if c_tap % 8 else tap), pooled


@torch.library.custom_op("open3dsot::fused_seg_head", mutates_args=(), device_types="cpu")
def _k2_op(tap: torch.Tensor, pooled: torch.Tensor, packed: torch.Tensor, w_pool: torch.Tensor,
           weights: List[torch.Tensor], biases: List[torch.Tensor], widths: List[int],
           bf16: bool = False) -> torch.Tensor:
    """K2 on the CPU: the plain version (`weights[0]` is W_tap and W_pool stacked)."""
    return _seg_head_layers(tap, pooled, list(zip(weights, biases)), bf16)


@_k2_op.register_fake
def _k2_fake(tap, pooled, packed, w_pool, weights, biases, widths, bf16=False):
    return tap.new_empty(tap.shape[0], tap.shape[1], widths[-1])


@_k2_op.register_kernel("cuda")
def _k2_cuda(tap, pooled, packed, w_pool, weights, biases, widths, bf16=False):
    B, N, _ = tap.shape
    if B > MAX_GRID_Y:  # the batch is the grid's y: a launch a slice of it
        return torch.cat([_k2_cuda(tap[b0:b1], pooled[b0:b1], packed, w_pool, weights, biases,
                                   widths, bf16) for b0, b1 in batch_slices(B)])
    dev = tap.device
    check("tap", tap, dev)
    check("pooled", pooled, dev)
    check("packed weights", packed, dev)
    check("w_pool", w_pool, dev)
    if widths[1] % 8:  # g and layer 0's output at the padded width, W_pool's columns padded
        w_pool = pad_to(w_pool, round8(widths[1]))
        widths = _padded_widths(widths, 1)
    g = torch.empty(B, widths[1], device=dev)
    out = torch.empty(B, N, widths[-1], device=dev)
    c_widths, n_layers = _c_widths(widths)
    workspace, _, k2 = _library(bf16)
    what = f"K2 {k2.__name__}"
    ws, ws_n = _workspace(workspace, c_widths, n_layers, B, N, dev, what)
    rc = k2(tap.data_ptr(), pooled.data_ptr(), w_pool.data_ptr(), packed.data_ptr(),
            packed.numel(), c_widths, n_layers, pooled.shape[1], B, N, g.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws_n, stream_of(tap))
    raise_on(rc, what, _ERRORS)
    fused_seg_head.launches += 1
    return out


# --- kernel wrappers ------------------------------------------------------

def fused_pointnet_encoder(x: torch.Tensor, chain: FoldedChain, *,
                           tap_at: Optional[int] = None
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K1: per-point folded chain + global max-pool, in the chain's mode
    (chain.dtype).

    x (B, N, C) -> (tap (B, N, C_tap) or None, pooled (B, C_last)), f32; bf16
    x is taken as f32 (exactly).
    """
    if x.dim() != 3 or x.shape[2] != chain.widths[0]:
        raise ValueError(f"x must be (B, N, {chain.widths[0]}), got {tuple(x.shape)}")
    if chain.split:
        raise ValueError("K1 takes a chain without a split first layer")
    on_cuda(x)  # a device with neither a kernel nor a plain version raises
    if x.dtype == BF16:
        x = x.float()
    tap, pooled = (_k1_cuda if direct(x) else _k1_op)(
        x, chain.packed, chain.weights, chain.biases, chain.packed_widths,
        -1 if tap_at is None else tap_at, is_bf16(chain.dtype))
    return (None if tap_at is None else tap), pooled


def fused_seg_head(tap: torch.Tensor, pooled: torch.Tensor, chain: FoldedChain) -> torch.Tensor:
    """K2: concat(tap, broadcast(pooled)) -> folded chain -> plain head, in
    the chain's mode (chain.dtype).

    tap (B, N, C_tap), pooled (B, C_pool) -> (B, N, C_out) f32. `chain` holds
    mlp2 and then the head as its last layer, split at C_tap.
    """
    if tap.dim() != 3 or pooled.dim() != 2 or pooled.shape[0] != tap.shape[0]:
        raise ValueError(f"tap (B, N, C) and pooled (B, C) expected, got "
                         f"{tuple(tap.shape)} and {tuple(pooled.shape)}")
    if chain.split != tap.shape[2] or chain.widths[0] != tap.shape[2] + pooled.shape[1]:
        raise ValueError(f"chain split {chain.split} / width {chain.widths[0]} does not match "
                         f"tap {tap.shape[2]} + pooled {pooled.shape[1]}")
    on_cuda(tap)
    return (_k2_cuda if direct(tap) else _k2_op)(
        tap, pooled, chain.packed, chain.w_pool, chain.weights, chain.biases,
        chain.packed_widths, is_bf16(chain.dtype))


fused_pointnet_encoder.launches = 0
fused_seg_head.launches = 0


def reset_launch_counts() -> None:
    fused_pointnet_encoder.launches = 0
    fused_seg_head.launches = 0
