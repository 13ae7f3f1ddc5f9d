"""Loss primitives, port of `open3dsot_tpu/models/losses.py`.

The reference trains with F.smooth_l1_loss / F.cross_entropy /
F.binary_cross_entropy_with_logits at their defaults; each helper keeps
that torch behaviour (reductions, how class weights normalise, where
pos_weight enters), written out as the JAX package writes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (huber), torch's default beta 1.0."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor, weight=None) -> torch.Tensor:
    """F.cross_entropy with optional class weights: logits (..., C), labels
    (...) int. With weights, 'mean' divides by the sum of the selected
    samples' weights, not by their count."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weight is not None:
        w = torch.as_tensor(weight, dtype=logits.dtype, device=logits.device)[labels.long()]
        return (nll * w).sum() / (w.sum() + 1e-12)
    return nll.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, pos_weight=None,
                    reduction: str = "mean") -> torch.Tensor:
    """F.binary_cross_entropy_with_logits: -(pw * t * log s(x) + (1 - t) *
    log s(-x)), pos_weight multiplying the positive term."""
    log_sig, log_sig_neg = F.logsigmoid(logits), F.logsigmoid(-logits)
    pos = targets * log_sig
    if pos_weight is not None:
        pos = pos_weight * pos
    loss = -(pos + (1.0 - targets) * log_sig_neg)
    if reduction == "mean":
        return loss.mean()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    raise ValueError(reduction)
