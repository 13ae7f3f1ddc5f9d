"""Shared building blocks, port of `open3dsot_tpu/models/layers.py`.

A "1x1 conv over (B, C, N)" of the reference is a Dense over the
channels-last layout (B, N, C). Child names follow the flax modules
(`dense`, `bn`, `layer{i}`), so the state_dict keys line up with the JAX
variable tree (weights.py). BatchNorm runs in eval mode only (eps 1e-5);
training-mode BatchNorm comes with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from open3dsot_tpu_torch.ops.chain_fused import BN_EPS, fold_dense_bn


class DenseBNRelu(nn.Module):
    """Dense -> BatchNorm (eval) -> ReLU over the last axis (any leading shape)."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 activation: bool = True, device=None):
        super().__init__()
        self.dense = nn.Linear(in_features, features, device=device)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS, momentum=0.1, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        if self.bn is not None:
            if self.training:
                raise NotImplementedError(
                    "training-mode BatchNorm is not ported yet (ROADMAP.md, modules to "
                    "port: training); call .eval()")
            bn = self.bn
            shape = x.shape
            x = F.batch_norm(x.reshape(-1, shape[-1]), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps).reshape(shape)
        if self.activation:
            x = torch.relu(x)
        return x

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
