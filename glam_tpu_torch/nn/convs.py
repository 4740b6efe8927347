"""Message-passing convolutions with the JAX package's semantics
(``nn/convs.py``).  Every conv takes ``forward(x, g)``: the node rows
[N, C] and the padded ``GraphBatch`` whose edges it reads.

  _TripletMessage       multi-head edge-conditioned attention, fused in
                        kernels A and B (``triplet_attention``) over the
                        real edges' CSR
  _TripletMessageLight  single-head attention over [x_i, e, x_j]; softmax
                        and aggregation in kernel C over every edge slot
  _GATConv              PyG GATConv (heads=1, self-loops); kernel C over
                        every edge slot and one loop per node
  _NNConv               PyG NNConv: per-edge [Ci, Co] weights from an edge
                        MLP, mean aggregation, root weight; plain torch
  _GCNConv              PyG GCNConv: self-loops, symmetric normalisation;
                        plain torch

All but ``_TripletMessage`` (whose padded messages are zero) see the
padded edges, as the JAX package's segment path does: they all point
from the last node to the last node with zero features, and that node's
row matches the JAX package's.  Weights keep
the JAX layout ([in, out]) except those of ``torch.nn.Linear`` and the
GCN/GAT ``weight``, which are torch's [out, in] (``convert`` transposes
them).  Gathers by sender or receiver go through the batch's CSRs
(``g.by_sender.gather``, ``g.by_receiver.gather``), whose backward sums
each node's rows in a fixed order, and so do the sums over receivers:
no ``index_add_`` atomics, the same bits on every call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.segment_softmax_spmm import segment_softmax_spmm
from ..ops.kernels.triplet_fused import triplet_attention
from .init import (glorot_bound, kaiming_uniform_bound, pyg_uniform_bound,
                   torch_linear_bound)

# convs whose GRU state update is disabled in MessageBlock
NO_GRU_CONVS = ("_GCNConv", "_GATConv")


def _leaky_relu(x, slope):
    return torch.where(x >= 0, x, slope * x)


class TripletMessage(torch.nn.Module):
    """Multi-head edge-conditioned attention message passing.

    math (per edge s->r, head h):
      x' = x Wn ; e' = e We                     (projections to H*C)
      a  = leaky_relu( [x'_r, e', x'_s] . w_h ) (attention logit)
      α  = segment_softmax(a over incoming edges of r)
      m  = α * e' * x'_s                        (elementwise, per head)
      out_r = (Σ_s m) reshaped to H*C @ Wscale + bias

    The attention logit is split into node and edge terms (a dot of a
    concatenation is a sum of dots); the edge term, the softmax and the
    aggregation run fused in :func:`triplet_attention`.
    """

    def __init__(self, channels: int, edge_channels: int, heads: int = 3,
                 negative_slope: float = 0.2):
        super().__init__()
        C, H = channels, heads
        self.channels, self.heads = C, H
        self.edge_channels = edge_channels
        self.negative_slope = negative_slope
        self.weight_node = torch.nn.Parameter(torch.empty(C, H * C))
        self.weight_edge = torch.nn.Parameter(
            torch.empty(edge_channels, H * C))
        self.weight_triplet_att = torch.nn.Parameter(torch.empty(H, 3 * C))
        self.weight_scale = torch.nn.Parameter(torch.empty(H * C, C))
        self.bias = torch.nn.Parameter(torch.empty(C))
        # [H*C, H] one-hot of each channel's head, for the block-diagonal
        # wemat (a_e = (edge_attr @ We) @ wemat)
        head_of = torch.arange(H * C) // C
        self.register_buffer("head_onehot",
                             F.one_hot(head_of, H).to(torch.float32),
                             persistent=False)

    def param_bounds(self):
        # the JAX package's fans: size(1) of each [in, out] weight, and
        # H * 3C for the attention tensor
        C, H = self.channels, self.heads
        return {"weight_node": kaiming_uniform_bound(H * C),
                "weight_edge": kaiming_uniform_bound(H * C),
                "weight_triplet_att": kaiming_uniform_bound(H * 3 * C),
                "weight_scale": kaiming_uniform_bound(C),
                "bias": 0.0}

    def forward(self, x, g):
        C, H = self.channels, self.heads
        xp = x @ self.weight_node                          # [N, H*C]
        w_i, w_e, w_j = self.weight_triplet_att.split(C, dim=1)
        xh = xp.view(-1, H, C)
        a_i = torch.einsum("nhc,hc->nh", xh, w_i).contiguous()
        a_j = torch.einsum("nhc,hc->nh", xh, w_j).contiguous()
        wemat = self.head_onehot * w_e.reshape(-1, 1)      # [H*C, H]
        # kernels A and B take float32: under a lower compute dtype the
        # inputs go up and the output comes back (JAX ``convs.py:105``)
        aggr = triplet_attention(
            xp.float(), a_i.float(), a_j.float(), g.edges.float(),
            self.weight_edge.float().contiguous(), wemat.float(),
            g.csr_rowptr, g.csr_snd, g.csr_eid, H, C,
            self.negative_slope, g.snd_rowptr, g.snd_eid).to(xp.dtype)
        return aggr @ self.weight_scale + self.bias


class TripletMessageLight(torch.nn.Module):
    """Single-head variant (``convs.py:130-166``): attention over
    [x_i, e_raw, x_j], message α·x'_j, bias-only update."""

    def __init__(self, channels: int, edge_channels: int,
                 negative_slope: float = 0.2):
        super().__init__()
        C = self.channels = channels
        self.edge_channels = edge_channels
        self.negative_slope = negative_slope
        self.weight_node = torch.nn.Parameter(torch.empty(C, C))
        self.weight_triplet_att = torch.nn.Parameter(
            torch.empty(2 * C + edge_channels))
        self.bias = torch.nn.Parameter(torch.empty(C))

    def param_bounds(self):
        C = self.channels
        return {"weight_node": kaiming_uniform_bound(C),
                "weight_triplet_att": kaiming_uniform_bound(
                    2 * C + self.edge_channels),
                "bias": 0.0}

    def forward(self, x, g):
        C, Fe = self.channels, self.edge_channels
        xp = x @ self.weight_node                          # [N, C]
        w_i, w_e, w_j = self.weight_triplet_att.split([C, Fe, C])
        a_i, a_j = xp @ w_i, xp @ w_j                      # [N]
        snd = g.by_sender
        logits = _leaky_relu(g.by_receiver.gather(a_i) + g.edges @ w_e
                             + snd.gather(a_j), self.negative_slope)  # [E]
        rowptr, idx = g.padded_csr
        aggr = segment_softmax_spmm(
            logits[:, None].float(), snd.gather(xp).float(), rowptr,
            idx).to(xp.dtype)
        return aggr + self.bias


class NNConv(torch.nn.Module):
    """Edge-conditioned conv, PyG NNConv (``convs.py:169-202``): edge MLP
    Linear(Fe, 32)-ReLU-Linear(32, Ci*Co), message x_s @ W(e), mean
    aggregation, root weight and bias.

    The per-edge matrices are [E, Ci, Co] float32 over every edge slot, as
    the JAX package computes them: by the shapes, 730 MB per message step
    at serving's 50,688 slots and Ci = Co = 60."""

    def __init__(self, in_channels: int, out_channels: int,
                 edge_channels: int, hidden: int = 32):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.edge_channels, self.hidden = edge_channels, hidden
        self.edge_mlp_0 = torch.nn.Linear(edge_channels, hidden)
        self.edge_mlp_1 = torch.nn.Linear(hidden, in_channels * out_channels)
        self.root = torch.nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = torch.nn.Parameter(torch.empty(out_channels))

    def param_bounds(self):
        b0 = torch_linear_bound(self.edge_channels)
        b1 = torch_linear_bound(self.hidden)
        b = pyg_uniform_bound(self.in_channels)
        return {"edge_mlp_0.weight": b0, "edge_mlp_0.bias": b0,
                "edge_mlp_1.weight": b1, "edge_mlp_1.bias": b1,
                "root": b, "bias": b}

    def forward(self, x, g):
        ci, co = self.in_channels, self.out_channels
        h1 = F.relu(self.edge_mlp_0(g.edges))
        wmat = self.edge_mlp_1(h1).view(-1, ci, co)         # [E, Ci, Co]
        msg = torch.bmm(g.by_sender.gather(x)[:, None, :],
                        wmat)[:, 0]                         # [E, Co]
        aggr = g.by_receiver.mean(msg)
        return aggr + x @ self.root + self.bias


class GCNConv(torch.nn.Module):
    """PyG GCNConv (``convs.py:205-238``): self-loops, symmetric
    normalisation, bias; the edge features are not used."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.weight = torch.nn.Parameter(torch.empty(out_channels,
                                                     in_channels))
        self.bias = torch.nn.Parameter(torch.empty(out_channels))

    def param_bounds(self):
        return {"weight": glorot_bound(self.in_channels + self.out_channels),
                "bias": 0.0}

    def forward(self, x, g):
        snd, rcv = g.by_sender, g.by_receiver
        xp = F.linear(x, self.weight)
        deg = rcv.count().to(xp.dtype) + 1.0
        dinv = torch.rsqrt(deg.clamp(min=1e-12))
        norm = snd.gather(dinv) * rcv.gather(dinv)
        out = rcv.sum(norm[:, None] * snd.gather(xp))
        return out + (dinv * dinv)[:, None] * xp + self.bias


class GATConv(torch.nn.Module):
    """PyG 1.7 GATConv (``convs.py:241-291``): multi-head concat, slope
    0.2, one self-loop per node appended to the edges."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 negative_slope: float = 0.2):
        super().__init__()
        H, C = heads, out_channels
        self.in_channels, self.heads, self.channels = in_channels, H, C
        self.negative_slope = negative_slope
        self.weight = torch.nn.Parameter(torch.empty(H * C, in_channels))
        self.att_src = torch.nn.Parameter(torch.empty(H, C))
        self.att_dst = torch.nn.Parameter(torch.empty(H, C))
        self.bias = torch.nn.Parameter(torch.empty(H * C))

    def param_bounds(self):
        H, C = self.heads, self.channels
        return {"weight": glorot_bound(self.in_channels + H * C),
                "att_src": glorot_bound(H + 2 * C),
                "att_dst": glorot_bound(H + 2 * C),
                "bias": 0.0}

    def forward(self, x, g):
        N, H, C = x.shape[0], self.heads, self.channels
        xp = F.linear(x, self.weight)                      # [N, H*C]
        xh = xp.view(N, H, C)
        a_src = torch.einsum("nhc,hc->nh", xh, self.att_src)
        a_dst = torch.einsum("nhc,hc->nh", xh, self.att_dst)
        # the E edges, then N self-loops (entry E + r is r's own row)
        snd, rcv = g.by_sender, g.by_receiver
        logits = _leaky_relu(
            torch.cat([snd.gather(a_src), a_src])
            + torch.cat([rcv.gather(a_dst), a_dst]),
            self.negative_slope)                           # [E+N, H]
        rowptr, idx = g.self_loop_csr
        out = segment_softmax_spmm(
            logits.float(), torch.cat([snd.gather(xp), xp]).float(), rowptr,
            idx).to(xp.dtype)
        return out + self.bias


def get_conv(name: str, in_dim: int, out_dim: int,
             edge_dim: int) -> torch.nn.Module:
    key = name.strip()
    if key == "_TripletMessage":
        return TripletMessage(channels=in_dim, edge_channels=edge_dim)
    if key == "_TripletMessageLight":
        return TripletMessageLight(channels=in_dim, edge_channels=edge_dim)
    if key == "_NNConv":
        return NNConv(in_dim, out_dim, edge_dim)
    if key == "_GCNConv":
        return GCNConv(in_dim, out_dim)
    if key == "_GATConv":
        return GATConv(in_dim, out_dim)
    raise KeyError(f"unknown conv {name!r}")
