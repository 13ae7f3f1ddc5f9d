"""Tracking metrics: Success / Precision AUC.

Reference definitions (/root/reference/utils/metrics.py:75-125):
- Precision = AUC (trapezoid) of the cumulative center-error curve over 21
  thresholds in [0, 2 m], x100/2.
- Success = AUC of the IoU-threshold curve over 21 thresholds in [0, 1], x100.

TPU-native redesign: instead of storing every per-frame value and
all-gathering lists at compute() (torchmetrics), state is a fixed-size
per-threshold *count vector* + total count. The curve value at threshold i is
counts[i]/total, so the state is exactly mergeable across devices/hosts with
a single psum / sum — O(21) communication regardless of dataset size.
"""

from __future__ import annotations

import numpy as np


class _ThresholdAUC:
    """Count-vector AUC accumulator over fixed thresholds."""

    def __init__(self, n: int, max_value: float, mode: str):
        assert mode in ("le", "ge")
        self.xaxis = np.linspace(0, max_value, num=n)
        self.max_value = max_value
        self.mode = mode
        self.reset()

    def reset(self) -> None:
        self.counts = np.zeros_like(self.xaxis)
        self.total = 0

    def update(self, values) -> None:
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if self.mode == "le":
            self.counts += (values[:, None] <= self.xaxis[None, :]).sum(axis=0)
        else:
            self.counts += (values[:, None] >= self.xaxis[None, :]).sum(axis=0)
        self.total += len(values)

    def __call__(self, values) -> None:
        self.update(values)

    def state(self) -> np.ndarray:
        """Mergeable state vector [counts..., total] (psum across devices)."""
        return np.concatenate([self.counts, [self.total]])

    def load_state(self, state: np.ndarray) -> None:
        self.counts = np.asarray(state[:-1], dtype=np.float64)
        self.total = float(state[-1])

    def merge(self, other: "_ThresholdAUC") -> None:
        self.counts += other.counts
        self.total += other.total

    def curve(self) -> np.ndarray:
        if self.total == 0:
            return np.zeros_like(self.xaxis)
        return self.counts / self.total

    def compute(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trapezoid(self.curve(), x=self.xaxis) * 100.0 / self.max_value)


class Precision(_ThresholdAUC):
    """AUC of cumulative center-error curve, 21 thresholds in [0, 2 m]."""

    def __init__(self, n: int = 21, max_accuracy: float = 2.0):
        super().__init__(n, max_accuracy, mode="le")


class Success(_ThresholdAUC):
    """AUC of the IoU-threshold curve, 21 thresholds in [0, 1]."""

    def __init__(self, n: int = 21, max_overlap: float = 1.0):
        super().__init__(n, max_overlap, mode="ge")


class AverageMeter:
    """Plain running average (reference metrics.py:8-24)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
