"""Weight initialisation with the JAX package's bounds (``nn/init.py``),
drawn from an explicit ``torch.Generator``.

Every parameter is drawn from U(-bound, bound), or set to a constant
where the JAX package's initializer is one (a norm's scale of ones, a
bias of zeros).  Each module of the port that owns parameters states
their bounds in ``param_bounds()`` (dotted names for those of a child
such as an ``nn.Linear``);
:func:`reset_parameters` draws a whole model and :func:`init_bounds`
collects its bounds under the ``state_dict`` names.  The numbers differ
from the JAX package's for the same seed (another generator); the bounds
are the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch


def kaiming_uniform_bound(fan_in: int) -> float:
    """torch ``kaiming_uniform_`` with a=0: sqrt(6 / fan_in)."""
    return math.sqrt(6.0 / fan_in)


def torch_linear_bound(fan_in: int) -> float:
    """torch Linear default, weight and bias: 1 / sqrt(fan_in)."""
    return 1.0 / math.sqrt(fan_in)


def rnn_bound(hidden_size: int) -> float:
    """torch RNN/GRU/LSTM default: 1 / sqrt(hidden_size)."""
    return 1.0 / math.sqrt(hidden_size)


def glorot_bound(fan_sum: int) -> float:
    """PyG's glorot: sqrt(6 / (fan_in + fan_out)), the summed fan given."""
    return math.sqrt(6.0 / fan_sum)


def pyg_uniform_bound(size: int) -> float:
    """PyG's uniform(size, tensor): 1 / sqrt(size)."""
    return 1.0 / math.sqrt(size)


@dataclasses.dataclass(frozen=True)
class Const:
    """A bound that is no bound: the parameter is set to ``value``."""
    value: float


def init_bounds(model: torch.nn.Module) -> Dict[str, Union[float, Const]]:
    """``{state_dict name: bound}`` for every parameter of ``model``."""
    out = {}
    for prefix, mod in model.named_modules():
        if hasattr(mod, "param_bounds"):
            for name, bound in mod.param_bounds().items():
                out[f"{prefix}.{name}" if prefix else name] = bound
    return out


@torch.no_grad()
def reset_parameters(model: torch.nn.Module,
                     generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from U(-bound, bound); a bound
    of 0 means zeros and a ``Const`` that constant."""
    bounds = init_bounds(model)
    missing = {n for n, _ in model.named_parameters()} - set(bounds)
    if missing:
        raise ValueError(f"parameters without a bound: {sorted(missing)}")
    for name, bound in bounds.items():
        p = model.get_parameter(name)
        if isinstance(bound, Const):
            p.fill_(bound.value)
        elif bound == 0.0:
            p.zero_()
        else:
            p.uniform_(-bound, bound, generator=generator)
