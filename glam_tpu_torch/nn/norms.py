"""Graph norms.  ``_None`` and ``_PairNorm`` are ported so far; the other
names of the JAX package's ``nn/norms.py`` raise and name their ROADMAP
item.

Every norm takes ``forward(x, node_graph=None, n_node=None,
node_mask=None)``: the graph id of each node row and the node count of
each graph (the padding graph included), or None for graph-level rows.
"""
from __future__ import annotations

import torch

from ..ops.segment import segment_sum

_NOT_PORTED = ("_BatchNorm", "_LayerNorm", "_GraphSizeNorm")


class NoNorm(torch.nn.Module):
    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x


class PairNorm(torch.nn.Module):
    """PyG PairNorm(scale=1, scale_individually=False, eps=1e-5), the JAX
    package's ``norms.py:114-132``: per graph, center the rows and divide
    by sqrt(eps + mean squared row norm).  Without ``node_graph`` the
    whole input is one graph.  Stateless."""

    def __init__(self, scale: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = scale, eps

    def forward(self, x: torch.Tensor, node_graph=None, n_node=None,
                **_) -> torch.Tensor:
        if node_graph is None:
            xc = x - x.mean(0)
            ms = (xc * xc).sum(-1).mean()
            return self.scale * xc / torch.sqrt(self.eps + ms)
        # index_select, not x[idx]: its backward is an index_add_, where
        # x[idx]'s is a sorting index_put_ (most of a training step's
        # device time on the card)
        G = n_node.shape[0]
        cnt = n_node.to(x.dtype).clamp(min=1.0)
        mean = segment_sum(x, node_graph, G) / cnt[:, None]
        xc = x - mean.index_select(0, node_graph)
        ms = segment_sum((xc * xc).sum(-1), node_graph, G) / cnt
        inv = torch.rsqrt(self.eps + ms).index_select(0, node_graph)
        return self.scale * xc * inv[:, None]


def get_norm(name: str, features: int) -> torch.nn.Module:
    key = name.strip()
    if key == "_None":
        return NoNorm()
    if key == "_PairNorm":
        return PairNorm()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"norm {key!r} is not ported yet (ROADMAP queue A, 'Rest of "
            "the layer library')")
    raise KeyError(f"unknown norm {name!r}")
