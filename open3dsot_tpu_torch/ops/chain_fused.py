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
Folded weights are (in, out) float32, as `fold_dense_bn` gives them.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # models/layers.py::DenseBNRelu epsilon, as on the JAX side

_ERRORS = {-1: "layer count, widths or packed size not accepted",
           -2: "a hidden width is not a multiple of 4",
           -3: "activations do not fit in shared memory"}


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


def _pad4(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return F.pad(t, (0, (-t.numel()) % 4))


class FoldedChain:
    """A chain of Dense layers, weights (in, out) and biases, ready for K1/K2.

    `split` > 0 marks K2's first layer, whose input is concat(tap, pooled):
    its first `split` rows (W_tap) go into the packed buffer and the rest
    (W_pool) into `w_pool`. The packed buffer holds each layer's W then b,
    every segment padded to 4 floats, in the order `csrc/chain_fused.cu`
    reads them.
    """

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]], split: int = 0):
        self.weights = [w.detach().float().contiguous() for w, _ in layers]
        self.biases = [b.detach().float().contiguous() for _, b in layers]
        self.widths = [self.weights[0].shape[0]] + [w.shape[1] for w in self.weights]
        self.split = split
        first = self.weights[0][:split] if split else self.weights[0]
        self.w_pool = self.weights[0][split:].contiguous() if split else None
        parts: List[torch.Tensor] = []
        for w, b in zip([first] + self.weights[1:], self.biases):
            parts += [_pad4(w), _pad4(b)]
        self.packed = torch.cat(parts)
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

def _check(name: str, t: torch.Tensor, device: torch.device, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{what} kernel failed: {msg}")


def _widths(chain: FoldedChain):
    w = chain.packed_widths
    return (ctypes.c_int * len(w))(*w), len(w) - 1


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
    if not _on_cuda(x):
        return pointnet_encoder_plain(x, chain, tap_at)
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = x.shape
    dev = x.device
    _check("x", x, dev)
    _check("packed weights", chain.packed, dev)
    tap = None
    if tap_at is not None:
        tap = torch.empty(B, N, chain.widths[tap_at + 1], device=dev)
    pooled = torch.empty(B, chain.widths[-1], device=dev)
    widths, n_layers = _widths(chain)
    lib = load_library("chain_fused").lib
    rc = lib.chain_fused_k1(
        x.data_ptr(), chain.packed.data_ptr(), chain.packed.numel(), widths, n_layers,
        B, N, -1 if tap_at is None else tap_at,
        None if tap is None else tap.data_ptr(), pooled.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K1 chain_fused_k1")
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
    if not _on_cuda(tap):
        return seg_head_plain(tap, pooled, chain)
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = tap.shape
    dev = tap.device
    _check("tap", tap, dev)
    _check("pooled", pooled, dev)
    _check("packed weights", chain.packed, dev)
    _check("w_pool", chain.w_pool, dev)
    g = torch.empty(B, chain.widths[1], device=dev)
    out = torch.empty(B, N, chain.widths[-1], device=dev)
    widths, n_layers = _widths(chain)
    lib = load_library("chain_fused").lib
    rc = lib.chain_fused_k2(
        tap.data_ptr(), pooled.data_ptr(), chain.w_pool.data_ptr(), chain.packed.data_ptr(),
        chain.packed.numel(), widths, n_layers, pooled.shape[1], B, N,
        g.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "K2 chain_fused_k2")
    fused_seg_head.launches += 1
    return out


fused_pointnet_encoder.launches = 0
fused_seg_head.launches = 0


def reset_launch_counts() -> None:
    fused_pointnet_encoder.launches = 0
    fused_seg_head.launches = 0
