"""Composite blocks: LinearBlock, GRUCell and MessageBlock, with the JAX
package's semantics (``nn/blocks.py``).

  LinearBlock   norm -> dropout -> Linear -> activation
  MessageBlock  norm -> dropout -> conv -> CELU -> GRU (state threaded
                across message steps; h = x on the first step) ->
                optional residual -> activation

Noise (dropout masks, RReLU slopes) is drawn only in ``train()`` mode,
from the ``torch.Generator`` the caller passes; a ``_BatchNorm`` takes
batch statistics in ``train()`` mode and its running ones in ``eval()``
mode.  Node-level blocks hand their norm the batch's ``node_graph``,
``n_node``, ``node_mask`` and ``graph_rowptr``, as the JAX package's
``blocks.py:55-58,115-118`` do; the conv gets the whole batch and reads
the edge structure it needs.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..data.graph import GraphBatch
from .activations import Activation, celu, need_generator
from .cells import gru_cell
from .convs import NO_GRU_CONVS, get_conv
from .init import rnn_bound, torch_linear_bound
from .norms import get_norm

_DROPOUT_RE = re.compile(r"^Dropout\(\s*(?:p\s*=\s*)?([0-9.]+)\s*\)$")


def parse_dropout(spec: str) -> float:
    """'_None()' -> 0.0, 'Dropout(0.2)' -> 0.2."""
    s = spec.strip()
    if s in ("_None()", "_None", "", "None"):
        return 0.0
    m = _DROPOUT_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse dropout spec {spec!r}")
    return float(m.group(1))


class Dropout(torch.nn.Module):
    """Inverted dropout whose mask is drawn from the caller's generator;
    the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        u = torch.rand(x.shape, generator=need_generator(generator,
                                                         "dropout"),
                       device=x.device, dtype=x.dtype)
        return torch.where(u >= self.rate, x / (1.0 - self.rate),
                           torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class LinearBlock(torch.nn.Module):
    def __init__(self, in_dim: int, out_dim: int, norm: str = "_None",
                 dropout: str = "_None()", act: str = "ReLU()"):
        super().__init__()
        self.in_dim = in_dim
        self.norm = get_norm(norm, in_dim)
        self.dropout = Dropout(parse_dropout(dropout))
        self.linear = torch.nn.Linear(in_dim, out_dim)
        self.act = Activation(act)

    def param_bounds(self):
        b = torch_linear_bound(self.in_dim)
        return {"linear.weight": b, "linear.bias": b}

    def forward(self, x: torch.Tensor, generator=None, node_graph=None,
                n_node=None, node_mask=None,
                graph_rowptr=None) -> torch.Tensor:
        x = self.norm(x, node_graph=node_graph, n_node=n_node,
                      node_mask=node_mask, graph_rowptr=graph_rowptr)
        return self.act(self.linear(self.dropout(x, generator)), generator)


class GRUCell(torch.nn.Module):
    """torch GRU (sequence length 1) cell: gate order (r, z, n), both
    biases, torch weight layout."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = torch.nn.Parameter(torch.empty(3 * hidden, in_dim))
        self.weight_hh = torch.nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = torch.nn.Parameter(torch.empty(3 * hidden))
        self.bias_hh = torch.nn.Parameter(torch.empty(3 * hidden))

    def param_bounds(self):
        b = rnn_bound(self.hidden)
        return {"weight_ih": b, "weight_hh": b, "bias_ih": b, "bias_hh": b}

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_cell(x, h, self.weight_ih, self.weight_hh, self.bias_ih,
                        self.bias_hh)


class MessageBlock(torch.nn.Module):
    def __init__(self, in_dim: int, out_dim: int, edge_dim: int,
                 norm: str = "_None", dropout: str = "Dropout(0.2)",
                 conv: str = "_NNConv", act: str = "ReLU()",
                 res: bool = True):
        super().__init__()
        self.res = res
        self.norm = get_norm(norm, in_dim)
        self.dropout = Dropout(parse_dropout(dropout))
        self.conv = get_conv(conv, in_dim, out_dim, edge_dim)
        self.gru = (GRUCell(in_dim, out_dim)
                    if conv.strip() not in NO_GRU_CONVS else None)
        self.act = Activation(act)

    def forward(self, x: torch.Tensor, g: GraphBatch, h=None,
                generator=None):
        identity = x
        if h is None:
            h = x
        y = self.norm(x, node_graph=g.node_graph, n_node=g.n_node,
                      node_mask=g.node_mask, graph_rowptr=g.graph_rowptr)
        y = self.dropout(y, generator)
        y = self.conv(y, g)
        if self.gru is not None:
            y = self.gru(celu(y), h)
            h = y
        if self.res:
            y = y + identity
        return self.act(y, generator), h
