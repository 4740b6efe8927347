"""Activation registry with the JAX package's semantics
(``nn/activations.py``).

RReLU: in training mode each element's negative slope is drawn from
U(1/8, 1/3) with the caller's ``torch.Generator`` (``activations.py:24-28``
of the JAX package draws it from the dropout key); in eval mode it is the
mean slope (1/8 + 1/3) / 2 = 11/48, as torch does.  The draws differ from
JAX's for the same seed; the distribution is the same.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

RRELU_LOWER = 1.0 / 8.0
RRELU_UPPER = 1.0 / 3.0
RRELU_EVAL_SLOPE = (RRELU_LOWER + RRELU_UPPER) / 2.0


def celu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Branch-safe CELU: expm1 only ever sees x <= 0.  One branch per
    element, so the derivative at x = 0 is 1 (a sum of the two clamps
    would pass the gradient through both there and give 2)."""
    return torch.where(x > 0, x,
                       alpha * torch.expm1(x.clamp(max=0.0) / alpha))


def _leaky(slope: float):
    return lambda x: torch.where(x >= 0, x, x * slope)


def need_generator(generator: Optional[torch.Generator],
                   what: str) -> torch.Generator:
    """``generator``, or a ValueError: training-mode noise is drawn from
    an explicit generator only."""
    if generator is None:
        raise ValueError(f"training-mode {what} needs a torch.Generator "
                         "(pass generator=...), or call .eval()")
    return generator


def rrelu_train(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """RReLU with a slope per element drawn from U(1/8, 1/3)."""
    slope = torch.empty_like(x).uniform_(RRELU_LOWER, RRELU_UPPER,
                                         generator=generator)
    return torch.where(x >= 0, x, x * slope)


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

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and self.key == "RReLU":
            return rrelu_train(x, need_generator(generator, "RReLU"))
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.key
