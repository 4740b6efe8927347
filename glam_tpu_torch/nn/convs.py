"""Message-passing convolutions.  Only ``_TripletMessage`` is ported so
far; the other names of the JAX package's ``nn/convs.py`` raise and name
their ROADMAP item."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.kernels.triplet_fused import triplet_attention
from .init import kaiming_uniform_bound

# convs whose GRU state update is disabled in MessageBlock
NO_GRU_CONVS = ("_GCNConv", "_GATConv")
_NOT_PORTED = ("_TripletMessageLight", "_NNConv", "_GCNConv", "_GATConv")


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
    aggregation run fused in :func:`triplet_attention`.  Weights keep the
    JAX package's [in, out] layout.
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

    def forward(self, x, edge_attr, csr_rowptr, csr_snd, csr_eid):
        C, H = self.channels, self.heads
        xp = x @ self.weight_node                          # [N, H*C]
        w_i, w_e, w_j = self.weight_triplet_att.split(C, dim=1)
        xh = xp.view(-1, H, C)
        a_i = torch.einsum("nhc,hc->nh", xh, w_i).contiguous()
        a_j = torch.einsum("nhc,hc->nh", xh, w_j).contiguous()
        wemat = self.head_onehot * w_e.reshape(-1, 1)      # [H*C, H]
        aggr = triplet_attention(
            xp, a_i, a_j, edge_attr, self.weight_edge.contiguous(), wemat,
            csr_rowptr, csr_snd, csr_eid, H, C, self.negative_slope)
        return aggr @ self.weight_scale + self.bias


def get_conv(name: str, in_dim: int, out_dim: int,
             edge_dim: int) -> torch.nn.Module:
    key = name.strip()
    if key == "_TripletMessage":
        return TripletMessage(channels=in_dim, edge_channels=edge_dim)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"conv {key!r} is not ported yet (ROADMAP queue A, 'Rest of "
            "the layer library')")
    raise KeyError(f"unknown conv {name!r}")
