"""Shared building blocks, port of `open3dsot_tpu/models/layers.py`.

A "1x1 conv over (B, C, N)" of the reference is a Dense over the
channels-last layout (B, N, C). Child names follow the flax modules
(`dense`, `bn`, `layer{i}`), so the state_dict keys line up with the JAX
variable tree (weights.py).

BatchNorm (eps 1e-5) follows flax, the reference of the port, in training
mode too: the batch variance is the biased one, mean(x^2) - mean(x)^2
clipped at 0, over every leading axis, and the running statistics blend
ra <- 0.9 ra + 0.1 batch with that biased variance (torch's own update uses
the unbiased one, so `F.batch_norm(training=True)` is not used). The update
is in place under no_grad; it bumps the buffers' versions, so a cached BN
fold (models/pointnet.py::_FoldCache) is refolded before the next eval
forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from open3dsot_tpu_torch.ops.chain_fused import BN_EPS, fold_dense_bn


def resolve_device(device) -> torch.device:
    """The device a model runs on; 'cuda' without a CUDA device raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


def refuse_bf16(config) -> None:
    """Every model runs in float32: the JAX package's bf16 compute (`bf16: true`)
    has no counterpart in the port yet, so a config asking for it is refused."""
    if getattr(config, "bf16", False):
        raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md, section 1 item 4: "
                                  "the bf16 paths of the kernels K1/K2 and K6 and of the "
                                  "layers around them); run in float32")


BN_MOMENTUM = 0.9  # flax's: ra <- m * ra + (1 - m) * batch


def batch_stats(x: torch.Tensor):
    """(mean, biased variance) over every leading axis, as flax computes them
    (use_fast_variance: mean(x^2) - mean(x)^2, clipped at 0)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    return mean, ((x * x).mean(dims) - mean * mean).clamp_min(0.0)


class DenseBNRelu(nn.Module):
    """Dense -> BatchNorm -> ReLU over the last axis (any leading shape)."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 activation: bool = True, device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, features, device=device)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS, momentum=0.1, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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

    def update_batch_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Blend a batch's (mean, biased variance) into the running statistics."""
        with torch.no_grad():
            self.bn.running_mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1.0 - BN_MOMENTUM)
            self.bn.running_var.mul_(BN_MOMENTUM).add_(var.detach().clamp_min(0.0),
                                                    alpha=1.0 - BN_MOMENTUM)

    def folded(self):
        """(W' (in, out), b') with this layer's eval BatchNorm folded in."""
        bn = self.bn
        return fold_dense_bn(self.dense.weight, self.dense.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)


class MLP(nn.Module):
    """Stack of DenseBNRelu layers `layer{i}`; `final_plain` makes the last
    one a bare Dense (no BN, no ReLU), as the reference's heads."""

    def __init__(self, in_features: int, channels: Sequence[int], final_plain: bool = False,
                 device=None):
        super().__init__()
        n = len(channels)
        widths = [in_features] + list(channels)
        for i in range(n):
            plain = final_plain and i == n - 1
            self.add_module(f"layer{i}", DenseBNRelu(widths[i], widths[i + 1], bn=not plain,
                                                     activation=not plain, device=device))

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
