"""Optimizer and learning-rate schedule, port of `open3dsot_tpu/train/optim.py`
(reference base_model.py:28-36).

Adam with betas (0.5, 0.999) and eps 1e-6, or SGD with momentum 0.9; both
with torch's coupled weight decay (grad += wd * p before the update), which
is what the JAX package's `optax.add_decayed_weights` placed before the
moment transform computes. The learning rate follows the reference's StepLR
per step: lr * rate ** ((step // steps_per_epoch) // decay_step), with step
0 at the first update (step the scheduler after each optimizer step, as
optax counts). `gradient_clip_val` > 0 clips the gradients' global norm
before the step (`clip_gradients`).
"""

from __future__ import annotations

import torch


def steplr_factor(steps_per_epoch: int, decay_step: int, decay_rate: float):
    """step -> the factor of the base learning rate at that step."""
    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return decay_rate ** (epoch // decay_step)

    return factor


def make_optimizer(config, params, steps_per_epoch: int):
    """-> (optimizer, per-step LambdaLR scheduler) over `params`."""
    params = list(params)
    wd = getattr(config, "wd", 0.0) or 0.0
    if config.optimizer.lower() == "sgd":
        optimizer = torch.optim.SGD(params, lr=config.lr, momentum=0.9, weight_decay=wd)
    else:
        optimizer = torch.optim.Adam(params, lr=config.lr, betas=(0.5, 0.999), eps=1e-6,
                                     weight_decay=wd)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, steplr_factor(steps_per_epoch, config.lr_decay_step, config.lr_decay_rate))
    return optimizer, scheduler


def clip_gradients(config, params) -> None:
    """Global-norm clipping at `gradient_clip_val`, when it is > 0."""
    clip = getattr(config, "gradient_clip_val", 0.0) or 0.0
    if clip > 0:
        torch.nn.utils.clip_grad_norm_(list(params), clip)
