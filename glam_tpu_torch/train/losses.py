"""Loss registry: the 15 names of the JAX package's ``train/losses.py``.

Each loss is ``loss(pred, target, weight=None) -> scalar`` over already
masked arrays; the weight is the trainers' mask (a weighted mean, the sum
of weights clamped at 1).  Notes as in the JAX package:
  huber/smae   torch SmoothL1Loss (beta=1)
  bce          expects probabilities; bcel expects logits
  kl           element mean of target*(log(target)-input), input=log-probs
  hinge        torch HingeEmbeddingLoss (targets in {1,-1})
  focal        FocalLoss(alpha=0.25, gamma=2) over 2-class logits
  mtce         log_softmax over the class dim + NLL, targets clipped
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _wmean(x, weight):
    if weight is None:
        return x.mean()
    w = weight.to(x.dtype)
    return (x * w).sum() / w.sum().clamp(min=1.0)


def _pick(logp, target):
    """logp[..., target] for integer-valued float targets."""
    # the gather's backward adds with atomics, one value into each row:
    # no two land in one place, so the bits are the same on every call
    return torch.gather(logp, -1, target.long()[..., None])[..., 0]


def mse(pred, target, weight=None):
    return _wmean((pred - target) ** 2, weight)


def mae(pred, target, weight=None):
    return _wmean((pred - target).abs(), weight)


def smooth_l1(pred, target, weight=None):
    d = (pred - target).abs()
    return _wmean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5), weight)


def bce_probs(pred, target, weight=None):
    p = pred.clamp(1e-12, 1.0 - 1e-12)
    return _wmean(-(target * torch.log(p) + (1 - target) * torch.log1p(-p)),
                  weight)


def bce_logits(pred, target, weight=None):
    # numerically stable BCEWithLogits
    loss = (pred.clamp(min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs())))
    return _wmean(loss, weight)


def cross_entropy(logits, target, weight=None, class_weight=None):
    """torch CrossEntropyLoss: logits [..., C], integer targets [...]."""
    nll_i = -_pick(F.log_softmax(logits, dim=-1), target)
    if class_weight is not None:
        w = class_weight[target.long()]
        if weight is not None:
            w = w * weight
        return (nll_i * w).sum() / w.sum().clamp(min=1e-12)
    return _wmean(nll_i, weight)


def nll(logp, target, weight=None):
    return _wmean(-_pick(logp, target), weight)


def kl_div(log_pred, target, weight=None):
    t = target.clamp(min=1e-12)
    return _wmean(target * (torch.log(t) - log_pred), weight)


def hinge_embedding(pred, target, weight=None, margin: float = 1.0):
    loss = torch.where(target > 0, pred, (margin - pred).clamp(min=0.0))
    return _wmean(loss, weight)


def focal(logits, target, weight=None, alpha: float = 0.25,
          gamma: float = 2.0):
    ce_i = -_pick(F.log_softmax(logits, dim=-1), target)
    pt = torch.exp(-ce_i)
    return _wmean(alpha * (1 - pt) ** gamma * ce_i, weight)


def multi_target_ce(logits, target, weight=None):
    """logits [N, T, C], integer targets [N, T]."""
    tgt = target.long().clamp(0, logits.shape[-1] - 1)
    return _wmean(-_pick(F.log_softmax(logits, dim=-1), tgt), weight)


LOSSES: Dict[str, Callable] = {
    "mse": mse,
    "mae": mae,
    "huber": smooth_l1,
    "smae": smooth_l1,
    "bce": bce_probs,
    "bcen": bce_probs,
    "bcel": bce_logits,
    "bceln": bce_logits,
    "mtce": multi_target_ce,
    "kl": kl_div,
    "hinge": hinge_embedding,
    "nll": nll,
    "ce": cross_entropy,
    "wce": cross_entropy,   # class-weighted CE (DTI screening trainer)
    "focal": focal,
}


def get_loss(name: str) -> Callable:
    if name not in LOSSES:
        raise ValueError(f"loss not found: {name!r}")
    return LOSSES[name]


# losses that consume 2-class logit pairs per task
CE_STYLE = frozenset({"ce", "mtce", "wce"})
# losses on 1-logit-per-task outputs
BCE_STYLE = frozenset({"bce", "bcel", "bcen", "bceln"})
