"""Fused eval-mode PointNet chains (SegPointNet / MiniPointNet), port of
`open3dsot_tpu/ops/chain_fused.py`.

Two kernels, CUDA C++ in `csrc/chain_fused.cu` (the design note is there):

  K1 `fused_pointnet_encoder`: per point, a chain of Dense layers with eval
     BatchNorm folded in, each followed by ReLU; optionally one layer is
     written out as a tap; the last layer is max-pooled over the points.
  K2 `fused_seg_head`: concat(tap, broadcast(pooled)) -> folded chain with
     ReLU -> plain head Dense -> per-point logits.

Each wrapper takes its plain PyTorch version (`pointnet_encoder_plain`,
`seg_head_plain`) for a tensor on the CPU, and launches its kernel for a
tensor on a CUDA device, or raises; nothing falls back. Each wrapper counts
its kernel launches in a plain integer attribute, `<wrapper>.launches`.

Layout is channels-last (B, N, C) at every function, as in the JAX package.
Folded weights are (in, out) float32, as `fold_dense_bn` gives them; the
kernels take them packed by `FoldedChain`: transposed to (out, in),
zero-padded to whole weight chunks and split into TF32 hi and lo parts for
the 3xTF32 tensor-core products.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of

BN_EPS = 1e-5  # models/layers.py::DenseBNRelu epsilon, as on the JAX side

# Tolerance of the kernels against f32: |k - ref| <= TOL * max|ref| + TOL * |ref|.
# 3xTF32 drops a_lo * w_lo, about 2^-22 of each product, and the tensor
# cores accumulate in f32 in another order than cuBLAS: an error of order
# 1e-6 relative over the chains' five layers (the CPU emulation of the
# kernel's arithmetic in tests/test_torch_chain_fused.py stays within this
# bound of float64, while TF32 alone does not). chip_smoke.py holds the
# kernels to their plain f32 versions with it.
TOL_3XTF32 = 1e-4

_ERRORS = {-1: "layer count, widths or packed size not accepted",
           -2: "the tap width or K2's first width is not a multiple of 8",
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


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits; the low 13 bits zero), to
    nearest with ties away from zero, as PTX `cvt.rna.tf32.f32` rounds."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(t), lo = tf32(t - hi): the 3xTF32 operands."""
    hi = tf32_rna(t)
    return hi, tf32_rna(t.float() - hi)


# The tensor cores' weight chunk: output x input channels (csrc/tf32_tc.cuh kCC, kKC)
CHUNK_OUT, CHUNK_IN = 128, 32


def pack_chunks(w: torch.Tensor) -> torch.Tensor:
    """A weight w (in, out) as the tensor cores read it (csrc/tf32_tc.cuh).
    W^T (out, in) is zero-padded to whole chunks of CHUNK_OUT x CHUNK_IN
    channels; the chunks follow each other output-chunk major, each W^T hi
    then W^T lo, each part in "core matrices" of 8 outputs x 4 inputs (128
    bytes), input-major within the chunk, as the tensor cores read B from
    shared memory."""
    k, c = w.shape
    nc, nk = -(-round8(c) // CHUNK_OUT), -(-round8(k) // CHUNK_IN)
    wt = w.new_zeros(nc * CHUNK_OUT, nk * CHUNK_IN)
    wt[:c, :k] = w.t()
    parts = [p.reshape(nc, CHUNK_OUT // 8, 8, nk, CHUNK_IN // 4, 4).permute(0, 3, 1, 4, 2, 5)
             for p in split_tf32(wt)]
    chunks = torch.stack(parts, dim=2)  # (out chunk, in chunk, hi/lo, 8s of out, 4s of in, 8, 4)
    return chunks.reshape(-1)


def pack_layer(w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One layer as K1/K2 read it: `pack_chunks(w)`, then b zero-padded to a
    multiple of 8."""
    c = w.shape[1]
    return torch.cat([pack_chunks(w), F.pad(b.float(), (0, round8(c) - c))])


class FoldedChain:
    """A chain of Dense layers, weights (in, out) and biases, ready for K1/K2.

    `split` > 0 marks K2's first layer, whose input is concat(tap, pooled):
    its first `split` rows (W_tap) go into the packed buffer and the rest
    (W_pool, f32 (in, out)) into `w_pool`. The packed buffer holds each
    layer as `pack_layer` lays it out, in the order `csrc/chain_fused.cu`
    reads them.
    """

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], split: int = 0):
        self.weights = [w.detach().float().contiguous() for w, _ in layers]
        self.biases = [b.detach().float().contiguous() for _, b in layers]
        self.widths = [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]
        self.split = split
        first = self.weights[0][:split] if split else self.weights[0]
        self.w_pool = self.weights[0][split:].contiguous() if split else None
        self.packed = torch.cat([pack_layer(w, b) for w, b in
                                 zip([first] + self.weights[1:], self.biases)])
        self.packed_widths = [first.shape[0]] + self.widths[1:]

    @property
    def layers(self):
        return list(zip(self.weights, self.biases))


# --- plain versions -------------------------------------------------------

def pointnet_encoder_plain(x: torch.Tensor, chain: FoldedChain,
                           tap_at: Optional[int] = None
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """x (B, N, C) -> (tap (B, N, C_tap) or None, pooled (B, C_last))."""
    h, tap = x, None
    for i, (w, b) in enumerate(chain.layers):
        h = torch.relu(h @ w + b)
        if i == tap_at:
            tap = h
    return tap, h.amax(dim=1)


def seg_head_plain(tap: torch.Tensor, pooled: torch.Tensor, chain: FoldedChain) -> torch.Tensor:
    """tap (B, N, C_tap), pooled (B, C_pool) -> (B, N, C_out); last layer plain."""
    B, N, _ = tap.shape
    h = torch.cat([tap, pooled[:, None, :].expand(B, N, pooled.shape[1])], dim=-1)
    layers = chain.layers
    for w, b in layers[:-1]:
        h = torch.relu(h @ w + b)
    w, b = layers[-1]
    return h @ w + b


# --- kernel wrappers ------------------------------------------------------

def _widths(chain: FoldedChain):
    w = chain.packed_widths
    return (ctypes.c_int * len(w))(*w), len(w) - 1


def _workspace(lib, widths, n_layers: int, B: int, N: int, dev, what: str):
    """Device memory between the kernels' launches, as the C side plans them."""
    n = lib.chain_fused_workspace(widths, n_layers, B, N)
    if n < 0:
        raise_on(n, what, _ERRORS)
    return torch.empty(max(n, 1), device=dev), n


def fused_pointnet_encoder(x: torch.Tensor, chain: FoldedChain, *,
                           tap_at: Optional[int] = None
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K1: per-point folded chain + global max-pool.

    x (B, N, C) -> (tap (B, N, C_tap) or None, pooled (B, C_last)).
    """
    if x.dim() != 3 or x.shape[2] != chain.widths[0]:
        raise ValueError(f"x must be (B, N, {chain.widths[0]}), got {tuple(x.shape)}")
    if chain.split:
        raise ValueError("K1 takes a chain without a split first layer")
    if not on_cuda(x):
        return pointnet_encoder_plain(x, chain, tap_at)
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = x.shape
    dev = x.device
    check("x", x, dev)
    check("packed weights", chain.packed, dev)
    tap = None
    if tap_at is not None:
        tap = torch.empty(B, N, chain.widths[tap_at + 1], device=dev)
    pooled = torch.empty(B, chain.widths[-1], device=dev)
    widths, n_layers = _widths(chain)
    lib = load_library("chain_fused").lib
    ws, ws_n = _workspace(lib, widths, n_layers, B, N, dev, "K1 chain_fused_k1")
    rc = lib.chain_fused_k1(
        x.data_ptr(), chain.packed.data_ptr(), chain.packed.numel(), widths, n_layers,
        B, N, -1 if tap_at is None else tap_at,
        None if tap is None else tap.data_ptr(), pooled.data_ptr(),
        ws.data_ptr(), ws_n, stream_of(x))
    raise_on(rc, "K1 chain_fused_k1", _ERRORS)
    fused_pointnet_encoder.launches += 1
    return tap, pooled


def fused_seg_head(tap: torch.Tensor, pooled: torch.Tensor, chain: FoldedChain) -> torch.Tensor:
    """K2: concat(tap, broadcast(pooled)) -> folded chain -> plain head.

    tap (B, N, C_tap), pooled (B, C_pool) -> (B, N, C_out). `chain` holds
    mlp2 and then the head as its last layer, split at C_tap.
    """
    if tap.dim() != 3 or pooled.dim() != 2 or pooled.shape[0] != tap.shape[0]:
        raise ValueError(f"tap (B, N, C) and pooled (B, C) expected, got "
                         f"{tuple(tap.shape)} and {tuple(pooled.shape)}")
    if chain.split != tap.shape[2] or chain.widths[0] != tap.shape[2] + pooled.shape[1]:
        raise ValueError(f"chain split {chain.split} / width {chain.widths[0]} does not match "
                         f"tap {tap.shape[2]} + pooled {pooled.shape[1]}")
    if not on_cuda(tap):
        return seg_head_plain(tap, pooled, chain)
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = tap.shape
    dev = tap.device
    check("tap", tap, dev)
    check("pooled", pooled, dev)
    check("packed weights", chain.packed, dev)
    check("w_pool", chain.w_pool, dev)
    g = torch.empty(B, chain.widths[1], device=dev)
    out = torch.empty(B, N, chain.widths[-1], device=dev)
    widths, n_layers = _widths(chain)
    lib = load_library("chain_fused").lib
    ws, ws_n = _workspace(lib, widths, n_layers, B, N, dev, "K2 chain_fused_k2")
    rc = lib.chain_fused_k2(
        tap.data_ptr(), pooled.data_ptr(), chain.w_pool.data_ptr(), chain.packed.data_ptr(),
        chain.packed.numel(), widths, n_layers, pooled.shape[1], B, N,
        g.data_ptr(), out.data_ptr(), ws.data_ptr(), ws_n, stream_of(tap))
    raise_on(rc, "K2 chain_fused_k2", _ERRORS)
    fused_seg_head.launches += 1
    return out


fused_pointnet_encoder.launches = 0
fused_seg_head.launches = 0


def reset_launch_counts() -> None:
    fused_pointnet_encoder.launches = 0
    fused_seg_head.launches = 0
