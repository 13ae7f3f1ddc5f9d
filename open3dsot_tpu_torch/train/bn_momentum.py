"""BatchNorm momentum schedule, port of `open3dsot_tpu/train/bn_momentum.py`
(reference BNMomentumScheduler, pointnet2/utils/pytorch_utils.py:272-297).

The momentum is torch's convention: running <- (1 - m) running + m batch.
The port's layers blend with `bn.momentum` itself
(models/layers.py::DenseBNRelu.update_batch_stats; K6's statistics reach
the same method), so the schedule sets it on every BatchNorm of the net
before an epoch, as the reference's scheduler sets it on its live modules.
The JAX package instead re-blends flax's 0.9-momentum statistics after the
forward (`reblend_batch_stats`), which gives the same statistics up to
rounding. The trainer turns the schedule on when `config.bn_decay_step` is
truthy.
"""

from __future__ import annotations

from typing import Callable

import torch.nn as nn

BN_MOMENTUM = 0.1  # torch convention; flax's momentum 0.9


def bn_momentum_schedule(initial: float = 0.1, decay: float = 0.5, step_size: int = 20,
                         floor: float = 0.01) -> Callable[[int], float]:
    """momentum(epoch) = max(initial * decay ** (epoch // step_size), floor)."""

    def schedule(epoch: int) -> float:
        return max(initial * (decay ** (epoch // step_size)), floor)

    return schedule


def set_bn_momentum(net: nn.Module, momentum: float) -> None:
    """Every BatchNorm of `net` blends its running statistics with `momentum`
    (torch convention) from now on."""
    for m in net.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.momentum = momentum
