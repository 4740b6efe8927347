"""Graph norms.  Only ``_None`` is ported so far; the other names of the
JAX package's ``nn/norms.py`` raise and name their ROADMAP item."""
from __future__ import annotations

import torch

_NOT_PORTED = ("_BatchNorm", "_LayerNorm", "_PairNorm", "_GraphSizeNorm")


class NoNorm(torch.nn.Module):
    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x


def get_norm(name: str, features: int) -> torch.nn.Module:
    key = name.strip()
    if key == "_None":
        return NoNorm()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"norm {key!r} is not ported yet (ROADMAP queue A, 'Rest of "
            "the layer library')")
    raise KeyError(f"unknown norm {name!r}")
