"""Activation registry with the JAX package's semantics
(``nn/activations.py``).

RReLU uses the mean slope (1/8 + 1/3) / 2 = 11/48 in eval mode, as torch
does.  Its training-mode noise comes with the training slice; a module in
training mode raises rather than run without it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RRELU_LOWER = 1.0 / 8.0
RRELU_UPPER = 1.0 / 3.0
RRELU_EVAL_SLOPE = (RRELU_LOWER + RRELU_UPPER) / 2.0


def celu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Branch-safe CELU: expm1 only ever sees x <= 0."""
    return x.clamp(min=0.0) + alpha * torch.expm1(x.clamp(max=0.0) / alpha)


def _leaky(slope: float):
    return lambda x: torch.where(x >= 0, x, x * slope)


_ACTS = {
    "_None": lambda x: x,
    "ReLU": F.relu,
    "LeakyReLU": _leaky(0.01),
    "CELU": celu,
    "RReLU": _leaky(RRELU_EVAL_SLOPE),
    "Sigmoid": torch.sigmoid,
    "PReLU": _leaky(0.25),      # torch's initial slope, fixed
}


def activation_key(name: str) -> str:
    key = name.strip().replace("()", "")
    if key not in _ACTS:
        raise KeyError(f"unknown activation {name!r}; have {sorted(_ACTS)}")
    return key


class Activation(torch.nn.Module):
    """An activation from its config string ('RReLU', 'CELU()', ...)."""

    def __init__(self, name: str):
        super().__init__()
        self.key = activation_key(name)
        self.fn = _ACTS[self.key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.key == "RReLU":
            raise NotImplementedError(
                "training-mode RReLU noise is not ported yet (ROADMAP "
                "queue A, training slice); call .eval() to serve")
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.key
