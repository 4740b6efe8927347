"""Graph norms with the JAX package's semantics (``nn/norms.py``).

  _BatchNorm     torch BatchNorm1d(eps=1e-5, momentum=0.1) over the real
                 nodes: the biased variance normalises, the unbiased one
                 goes into the running statistics
  _LayerNorm     PyG graph LayerNorm: scalar mean and variance per graph
                 over all node*channel entries, affine per channel
  _PairNorm      PyG PairNorm(scale=1): per graph, center, divide by
                 sqrt(eps + mean squared row norm)
  _GraphSizeNorm x_i / sqrt(|V_g|)
  _None          identity

Every norm takes ``forward(x, node_graph=None, n_node=None,
node_mask=None, graph_rowptr=None)``: the graph id of each node row and
the node count of each graph (the padding graph included), or None for
graph-level rows, and the batch's row pointers of nodes by graph
(``GraphBatch.graph_rowptr``; the prefix sums of ``n_node`` when None).
``_BatchNorm`` takes statistics of the batch in ``train()`` mode (over
the rows of ``node_mask``, or every row without one) and updates its
running statistics, buffers ``mean`` and ``var`` (so ``state_dict``,
checkpoints and resume carry them); in ``eval()`` mode it normalises
with them, as the JAX package's ``use_running_average=deterministic``.

Sums per graph and the backward of gathers per graph run in a fixed
order, through the CSR of the nodes by graph (``ops/segment.py``
``Segments``): the same bits on every call.
"""
from __future__ import annotations

import math

import torch

from ..data.graph import graph_csr
from ..ops.segment import Segments
from .init import Const


def by_graph(node_graph, n_node, graph_rowptr=None) -> Segments:
    """Node rows by graph: the batch's CSR, or one made from ``n_node``
    (on its device, no host synchronisation)."""
    if graph_rowptr is None:
        graph_rowptr = graph_csr(n_node, node_graph.shape[0])[0]
    return Segments(node_graph, graph_rowptr)


class NoNorm(torch.nn.Module):
    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return x


class BatchNorm(torch.nn.Module):
    """Masked BatchNorm1d with torch semantics (``norms.py:38-86``)."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = torch.nn.Parameter(torch.ones(features))
        self.bias = torch.nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def param_bounds(self):
        return {"scale": Const(1.0), "bias": 0.0}

    def forward(self, x: torch.Tensor, node_mask=None, **_) -> torch.Tensor:
        if not self.training:
            mean, var = self.mean, self.var
        else:
            if node_mask is None:
                m = x.new_ones((x.shape[0], 1))
            else:
                m = node_mask.to(x.dtype)[:, None]
            cnt = m.sum().clamp(min=1.0)
            mean = (x * m).sum(0) / cnt
            var = (((x - mean) ** 2) * m).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                mom = self.momentum
                self.mean.copy_((1 - mom) * self.mean + mom * mean)
                self.var.copy_((1 - mom) * self.var + mom * unbiased)
        inv = torch.reciprocal(torch.sqrt(var + self.eps))
        # the float32 running statistics lift a lower compute dtype to
        # float32, as in JAX; the output goes back to x's dtype, since
        # torch's matmuls do not promote mixed dtypes as jnp's do
        return ((x - mean) * inv * self.scale + self.bias).to(x.dtype)


class GraphLayerNorm(torch.nn.Module):
    """PyG LayerNorm(in_channels) with batch: one scalar mean and variance
    per graph; over all the entries without ``node_graph``
    (``norms.py:89-111``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = torch.nn.Parameter(torch.ones(features))
        self.bias = torch.nn.Parameter(torch.zeros(features))

    def param_bounds(self):
        return {"scale": Const(1.0), "bias": 0.0}

    def forward(self, x: torch.Tensor, node_graph=None, n_node=None,
                graph_rowptr=None, **_) -> torch.Tensor:
        if node_graph is None:
            xc = x - x.mean()
            out = xc / torch.sqrt((xc ** 2).mean() + self.eps)
        else:
            graphs = by_graph(node_graph, n_node, graph_rowptr)
            norm = n_node.to(x.dtype).clamp(min=1.0) * x.shape[-1]
            mean = graphs.sum(x.sum(-1)) / norm
            xc = x - graphs.gather(mean)[:, None]
            var = graphs.sum((xc * xc).sum(-1)) / norm
            out = xc / graphs.gather(torch.sqrt(var + self.eps))[:, None]
        return out * self.scale + self.bias


class PairNorm(torch.nn.Module):
    """PyG PairNorm(scale=1, scale_individually=False, eps=1e-5), the JAX
    package's ``norms.py:114-132``: per graph, center the rows and divide
    by sqrt(eps + mean squared row norm).  Without ``node_graph`` the
    whole input is one graph.  Stateless."""

    def __init__(self, scale: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = scale, eps

    def forward(self, x: torch.Tensor, node_graph=None, n_node=None,
                graph_rowptr=None, **_) -> torch.Tensor:
        if node_graph is None:
            xc = x - x.mean(0)
            ms = (xc * xc).sum(-1).mean()
            return self.scale * xc / torch.sqrt(self.eps + ms)
        graphs = by_graph(node_graph, n_node, graph_rowptr)
        cnt = n_node.to(x.dtype).clamp(min=1.0)
        mean = graphs.sum(x) / cnt[:, None]
        xc = x - graphs.gather(mean)
        ms = graphs.sum((xc * xc).sum(-1)) / cnt
        inv = graphs.gather(torch.rsqrt(self.eps + ms))
        return self.scale * xc * inv[:, None]


class GraphSizeNorm(torch.nn.Module):
    """PyG GraphSizeNorm: x_i / sqrt(node count of graph(i)); without
    ``node_graph``, / sqrt(rows).  Stateless."""

    def forward(self, x: torch.Tensor, node_graph=None, n_node=None,
                **_) -> torch.Tensor:
        if node_graph is None:
            return x / math.sqrt(x.shape[0])
        n = n_node.to(x.dtype)
        inv = torch.where(n_node > 0, 1.0 / torch.sqrt(n.clamp(min=1.0)),
                          torch.ones_like(n))
        # inv comes from the counts alone: no gradient to sum
        return x * inv.index_select(0, node_graph)[:, None]


def get_norm(name: str, features: int) -> torch.nn.Module:
    key = name.strip()
    if key == "_None":
        return NoNorm()
    if key == "_BatchNorm":
        return BatchNorm(features)
    if key == "_LayerNorm":
        return GraphLayerNorm(features)
    if key == "_PairNorm":
        return PairNorm()
    if key == "_GraphSizeNorm":
        return GraphSizeNorm()
    raise KeyError(f"unknown norm {name!r}")
