"""Graph readouts with the JAX package's semantics (``nn/readouts.py``):
x [N, C] padded node rows -> [G, k*C].

  GlobalPool5   concat[mean, sum, top-3 by the last channel] -> 5C
  GlobalLAPool  PyG GlobalAttention(gate=Linear(C, 1), nn=Linear(C, 2C))
                -> 2C
  Set2Set       PyG Set2Set(processing_steps=3), an LSTM(2C -> C)
                attention readout -> 2C

The attention readouts send their softmax-weighted sums through the
segment-softmax kernel (``segment_softmax_spmm``), with graphs as rows
and nodes as entries; GlobalPool5's sum and the backward of Set2Set's
gather per graph run through the fixed-order CSR sum.  Every readout
takes ``forward(x, node_graph, node_pos, n_node, graph_rowptr=None)``,
the last the batch's row pointers of nodes by graph (made from
``n_node`` when None).  The padding graph is one of those rows, so its
softmax over every padding node is computed as the JAX package does.
"""
from __future__ import annotations

import torch

from ..ops.kernels.segment_softmax_spmm import segment_softmax_spmm
from ..ops.segment import segment_topk_by_channel
from .cells import lstm_cell
from .init import rnn_bound, torch_linear_bound
from .norms import by_graph


class GlobalPool5(torch.nn.Module):
    """[mean, sum, top-3-by-last-channel] concat readout -> 5C."""

    def __init__(self, channels: int, max_nodes: int = 128, k: int = 3):
        super().__init__()
        self.channels, self.max_nodes, self.k = channels, max_nodes, k

    def forward(self, x, node_graph, node_pos, n_node, graph_rowptr=None):
        G = n_node.shape[0]
        total = by_graph(node_graph, n_node, graph_rowptr).sum(x)
        mean = total / n_node.clamp(min=1).to(x.dtype)[:, None]
        topk = segment_topk_by_channel(x, node_graph, node_pos, G,
                                       self.max_nodes, self.k)
        return torch.cat([mean, total, topk], dim=-1)


class GlobalLAPool(torch.nn.Module):
    """Gated attention pool: softmax over each graph's nodes of gate(x),
    weights on nn(x) -> 2C."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.gate_nn = torch.nn.Linear(channels, 1)
        self.nn = torch.nn.Linear(channels, 2 * channels)

    def param_bounds(self):
        b = torch_linear_bound(self.channels)
        return {"gate_nn.weight": b, "gate_nn.bias": b, "nn.weight": b,
                "nn.bias": b}

    def forward(self, x, node_graph, node_pos, n_node, graph_rowptr=None):
        graphs = by_graph(node_graph, n_node, graph_rowptr)
        # kernel C takes float32 (see TripletMessage.forward); the node
        # rows are in graph order, so slot k is node k
        return segment_softmax_spmm(self.gate_nn(x).float(),
                                    self.nn(x).float(), graphs.rowptr,
                                    _node_order(x)).to(x.dtype)


class Set2Set(torch.nn.Module):
    """PyG Set2Set with processing_steps=3:

      q_star_0 = 0; for t in 1..T:
        q, (h, c) = LSTM(q_star, (h, c));  e_i = <x_i, q_graph(i)>
        a = segment_softmax(e);  r_g = Σ a_i x_i;  q_star = [q, r]

    Output q_star [G, 2C].  The LSTM's weights keep the JAX package's
    names and [in, 4C] layout (``lstm_w_ih`` ...), gate order (i, f, g,
    o), all drawn from U(-1/sqrt(C), 1/sqrt(C))."""

    def __init__(self, channels: int, processing_steps: int = 3):
        super().__init__()
        C = self.channels = channels
        self.processing_steps = processing_steps
        self.lstm_w_ih = torch.nn.Parameter(torch.empty(2 * C, 4 * C))
        self.lstm_w_hh = torch.nn.Parameter(torch.empty(C, 4 * C))
        self.lstm_b_ih = torch.nn.Parameter(torch.empty(4 * C))
        self.lstm_b_hh = torch.nn.Parameter(torch.empty(4 * C))

    def param_bounds(self):
        b = rnn_bound(self.channels)
        return {n: b for n in ("lstm_w_ih", "lstm_w_hh", "lstm_b_ih",
                               "lstm_b_hh")}

    def forward(self, x, node_graph, node_pos, n_node, graph_rowptr=None):
        C, G = self.channels, n_node.shape[0]
        graphs = by_graph(node_graph, n_node, graph_rowptr)
        rowptr, idx = graphs.rowptr, _node_order(x)
        q_star = x.new_zeros((G, 2 * C))
        h = x.new_zeros((G, C))
        c = x.new_zeros((G, C))
        for _ in range(self.processing_steps):
            q, c = lstm_cell(q_star, h, c, self.lstm_w_ih, self.lstm_w_hh,
                             self.lstm_b_ih, self.lstm_b_hh)
            h = q
            e = (x * graphs.gather(q)).sum(-1)                    # [N]
            r = segment_softmax_spmm(e[:, None].float(), x.float(), rowptr,
                                     idx).to(x.dtype)             # [G, C]
            q_star = torch.cat([q, r], dim=-1)
        return q_star


def _node_order(x):
    """Kernel C's slot entries over node rows in order: 0..N-1 (int32)."""
    return torch.arange(x.shape[0], dtype=torch.int32, device=x.device)


def get_readout(name: str, channels: int, max_nodes: int):
    """-> (module, width multiplier)."""
    key = name.strip()
    if key == "GlobalPool5":
        return GlobalPool5(channels, max_nodes), 5
    if key == "GlobalLAPool":
        return GlobalLAPool(channels), 2
    if key == "Set2Set":
        return Set2Set(channels), 2
    raise KeyError(f"unknown readout {name!r}")
