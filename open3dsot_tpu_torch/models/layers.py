"""Shared building blocks, port of `open3dsot_tpu/models/layers.py`.

A "1x1 conv over (B, C, N)" of the reference is a Dense over the
channels-last layout (B, N, C). Child names follow the flax modules
(`dense`, `bn`, `layer{i}`), so the state_dict keys line up with the JAX
variable tree (weights.py).

BatchNorm (eps 1e-5) follows flax, the reference of the port, in training
mode too: the batch variance is the biased one, mean(x^2) - mean(x)^2
clipped at 0, over every leading axis, and the running statistics blend
ra <- (1 - m) ra + m batch with that biased variance (torch's own update
uses the unbiased one, so `F.batch_norm(training=True)` is not used); m is
the BatchNorm's `momentum`, 0.1 (flax's 0.9) unless train/bn_momentum.py
schedules it. The update
is in place under no_grad; it bumps the buffers' versions, so a cached BN
fold (models/pointnet.py::_FoldCache) is refolded before the next eval
forward.

bf16 compute (`dtype=torch.bfloat16`, JAX `dtype=jnp.bfloat16`) follows
flax's rounding order: `nn.Dense(dtype=bf16)` rounds its input, kernel and
bias to bf16, multiplies with f32 sums and rounds the product to bf16, then
adds the bias in bf16; `nn.BatchNorm(dtype=bf16)` computes (x - mean) *
(rsqrt(var + eps) * scale) + bias in the statistics' type (f32, or bf16
where the statistics themselves are bf16) and rounds the result to bf16;
ReLU keeps bf16. In training the batch statistics are computed in f32 from
the bf16 product (flax's `_compute_stats` promotes to f32) and blended into
the f32 running statistics. Parameters, their gradients and the statistics
stay f32 (the scan tracker rounds a copy of them): autograd through a
`.to(bfloat16)` hands an f32 gradient back to the f32 parameter, as JAX's
convert does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from open3dsot_tpu_torch.ops.chain_fused import BF16, BN_EPS, fold_dense_bn, is_bf16
from open3dsot_tpu_torch.parallel import distributed


def resolve_device(device) -> torch.device:
    """The device a model runs on; 'cuda' without a CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


def compute_dtype(config):
    """torch.bfloat16 under `bf16: true`, else None (float32), as JAX's
    models/matching_base.py::_compute_dtype."""
    return BF16 if getattr(config, "bf16", False) else None


def set_compute_dtype(net: nn.Module, dtype) -> nn.Module:
    """Every module of `net` with a compute dtype (`dtype` attribute: the
    layers, encoders and SA layers of the port) computes in `dtype` from now
    on; its fold caches refold for the new mode at their next use."""
    dtype = BF16 if is_bf16(dtype) else None
    for m in net.modules():
        if "dtype" in vars(m):
            m.dtype = dtype
    return net


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """A bf16 result back in f32 (JAX's `.astype(jnp.float32)` after a bf16
    head); any other dtype, float64 in the reference runs, as it is."""
    return x.float() if x.dtype == BF16 else x


def computes_in_bf16(net: nn.Module) -> bool:
    """Whether any module of `net` computes in bf16."""
    return any(vars(m).get("dtype") is BF16 for m in net.modules())


def linear(x: torch.Tensor, dense: nn.Linear, dtype) -> torch.Tensor:
    """A bare Dense (a head, conv_final) in the compute dtype: flax's
    nn.Dense(dtype=bf16) rounding in the bf16 mode."""
    return dense_bf16(x, dense) if is_bf16(dtype) else dense(x)


def batch_stats(x: torch.Tensor):
    """(mean, biased variance) over every leading axis, as flax computes them
    (use_fast_variance: mean(x^2) - mean(x)^2, clipped at 0). Inside
    `distributed.global_batch()` they are those of the global batch: the
    sums of x and x^2 and the row count summed over the ranks, whose
    backward sums the cotangents of those sums (from dy and dy * yhat) over
    the ranks too."""
    dims = tuple(range(x.dim() - 1))
    if distributed.in_global_batch():
        C = x.shape[-1]
        sums = distributed.sum_over_batch(torch.cat(
            [x.sum(dims), (x * x).sum(dims), x.new_full((1,), x.numel() // C)]))
        mean = sums[:C] / sums[-1]
        return mean, (sums[C:2 * C] / sums[-1] - mean * mean).clamp_min(0.0)
    mean = x.mean(dims)
    return mean, ((x * x).mean(dims) - mean * mean).clamp_min(0.0)


def dense_bf16(x: torch.Tensor, dense: nn.Linear) -> torch.Tensor:
    """flax nn.Dense(dtype=bf16): x, kernel and bias rounded to bf16, the
    product with f32 sums rounded to bf16, plus the bias in bf16."""
    y = (x.to(BF16).float() @ dense.weight.to(BF16).float().t()).to(BF16)
    return y + dense.bias.to(BF16)


class DenseBNRelu(nn.Module):
    """Dense -> BatchNorm -> ReLU over the last axis (any leading shape);
    `dtype` None (float32) or torch.bfloat16."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 activation: bool = True, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(in_features, features, device=device)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS, momentum=0.1, device=device) if bn else None
        self.activation = activation
        self.dtype = BF16 if is_bf16(dtype) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            return self._forward_bf16(x)
        x = self.dense(x)
        bn = self.bn
        if bn is not None and self.training:
            mean, var = batch_stats(x)
            self.update_batch_stats(mean, var)
            x = (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        elif bn is not None:
            shape = x.shape
            x = F.batch_norm(x.reshape(-1, shape[-1]), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps).reshape(shape)
        if self.activation:
            x = torch.relu(x)
        return x

    def _forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 in flax's order (the module docstring), in eval and in training."""
        x = dense_bf16(x, self.dense)
        bn = self.bn
        if bn is not None and self.training:
            mean, var = batch_stats(x.float())  # f32 statistics of the bf16 product
            self.update_batch_stats(mean, var)
            x = ((x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias).to(BF16)
        elif bn is not None:
            mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
            x = ((x - bn.running_mean) * mul + bn.bias).to(BF16)
        if self.activation:
            x = torch.relu(x)
        return x

    def update_batch_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Blend a batch's (mean, biased variance) into the running statistics
        with the BatchNorm's momentum m: ra <- (1 - m) ra + m batch."""
        keep = 1.0 - self.bn.momentum  # flax's momentum: 0.9 at torch's default 0.1
        with torch.no_grad():
            self.bn.running_mean.mul_(keep).add_(mean.detach(), alpha=1.0 - keep)
            self.bn.running_var.mul_(keep).add_(var.detach().clamp_min(0.0), alpha=1.0 - keep)

    def folded(self):
        """(W' (in, out), b') with this layer's eval BatchNorm folded in."""
        bn = self.bn
        return fold_dense_bn(self.dense.weight, self.dense.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)


class MLP(nn.Module):
    """Stack of DenseBNRelu layers `layer{i}`; `final_plain` makes the last
    one a bare Dense (no BN, no ReLU), as the reference's heads."""

    def __init__(self, in_features: int, channels: Sequence[int], final_plain: bool = False,
                 device=None, dtype=None):
        super().__init__()
        n = len(channels)
        widths = [in_features] + list(channels)
        for i in range(n):
            plain = final_plain and i == n - 1
            self.add_module(f"layer{i}", DenseBNRelu(widths[i], widths[i + 1], bn=not plain,
                                                     activation=not plain, device=device,
                                                     dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x

    def folded(self):
        return [layer.folded() for layer in self.children()]

    def update_batch_stats(self, stats) -> None:
        """stats: one (batch_mean, batch_var) per layer, from a fused kernel (K6)."""
        for layer, (mean, var) in zip(self.children(), stats):
            layer.update_batch_stats(mean, var)
