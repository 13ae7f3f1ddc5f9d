"""PointNet encoders of M2-Track, port of `open3dsot_tpu/models/pointnet.py`
(MiniPointNet, SegPointNet; reference models/backbone/pointnet.py:91-204).

With `fused_eval` (the default) the eval forward goes through the fused
chain kernels K1/K2 (ops/chain_fused.py); the plain layer stack is kept for
`fused_eval=False` (the plain PyTorch forward that the kernels are held
against) and for training later. The folded weights are cached and folded
again whenever a parameter or buffer changes: a load_state_dict (in-place
copy, bumping the tensor version) or a .to() (new storage).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from open3dsot_tpu_torch.models.layers import MLP
from open3dsot_tpu_torch.ops.chain_fused import (
    FoldedChain,
    fused_pointnet_encoder,
    fused_seg_head,
)


class _FoldCache(nn.Module):
    """Caches `self._fold()` until a parameter or buffer changes."""

    def _weights_key(self):
        return tuple((t.data_ptr(), t._version) for t in (*self.parameters(), *self.buffers()))

    def folded_chains(self):
        if self.training:
            raise NotImplementedError("the fused chains are eval-only: call .eval()")
        key = self._weights_key()
        if getattr(self, "_fold_key", None) != key:
            with torch.no_grad():
                self._fold_value = self._fold()
            self._fold_key = key
        return self._fold_value


class MiniPointNet(_FoldCache):
    """Per-point MLP -> global max-pool -> hidden MLP [-> fc]."""

    def __init__(self, in_channels: int, per_point_mlp: Sequence[int], hidden_mlp: Sequence[int],
                 output_size: int = 0, fused_eval: bool = True, device=None):
        super().__init__()
        self.per_point = MLP(in_channels, per_point_mlp, device=device)
        self.hidden = MLP(per_point_mlp[-1], hidden_mlp, device=device)
        self.fc = (nn.Linear(hidden_mlp[-1], output_size, device=device)
                   if output_size > 0 else None)
        self.fused_eval = fused_eval

    def _fold(self):
        return FoldedChain(self.per_point.folded())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C) -> (B, hidden_mlp[-1] or output_size)."""
        if self.fused_eval:
            _, x = fused_pointnet_encoder(x, self.folded_chains())
        else:
            x = self.per_point(x).amax(dim=1)
        x = self.hidden(x)
        if self.fc is not None:
            x = self.fc(x)
        return x


class SegPointNet(_FoldCache):
    """Per-point mlp1 with a layer-1 tap, global max-pool broadcast back per
    point, mlp2, and a plain head: x (B, N, C) -> (B, N, output_size)."""

    TAP_AT = 1

    def __init__(self, in_channels: int, per_point_mlp1: Sequence[int],
                 per_point_mlp2: Sequence[int], output_size: int,
                 fused_eval: bool = True, device=None):
        super().__init__()
        widths = [in_channels] + list(per_point_mlp1)
        for i, ch in enumerate(per_point_mlp1):
            self.add_module(f"mlp1_{i}", MLP(widths[i], [ch], device=device))
        c_tap, c_pool = per_point_mlp1[self.TAP_AT], per_point_mlp1[-1]
        widths = [c_tap + c_pool] + list(per_point_mlp2)
        for i, ch in enumerate(per_point_mlp2):
            self.add_module(f"mlp2_{i}", MLP(widths[i], [ch], device=device))
        self.fc = nn.Linear(per_point_mlp2[-1], output_size, device=device)
        self.n1, self.n2 = len(per_point_mlp1), len(per_point_mlp2)
        self.c_tap = c_tap
        self.fused_eval = fused_eval

    def _fold(self):
        mlp1 = [getattr(self, f"mlp1_{i}").layer0.folded() for i in range(self.n1)]
        mlp2 = [getattr(self, f"mlp2_{i}").layer0.folded() for i in range(self.n2)]
        head = (self.fc.weight.t().contiguous(), self.fc.bias)
        return FoldedChain(mlp1), FoldedChain(mlp2 + [head], split=self.c_tap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused_eval:
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
        return self.fc(x)
