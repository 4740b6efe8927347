"""Segment (scatter/gather) primitives in plain torch.

The counterparts of the JAX package's ``ops/segment.py``.  All functions
assume the GraphBatch padding convention (padded edges point at padding
nodes), so no masking is needed: padded contributions land in padding
segments.  Index tensors are int64.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean with zero for empty segments (torch_scatter 'mean')."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_count(segment_ids, num_segments).clamp(min=1.0)
    return tot / cnt.reshape((-1,) + (1,) * (tot.dim() - 1)).to(tot.dtype)


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Entries per segment (float32)."""
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def csr_rows(rowptr: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Row of each CSR slot (int64), from the row pointers; no host
    synchronisation (the slot count is given)."""
    counts = (rowptr[1:] - rowptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(rowptr.shape[0] - 1, device=rowptr.device), counts,
        output_size=n_slots)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax within segments with PyG semantics: subtract the segment
    max (0 for empty segments), divide by the segment sum plus 1e-16."""
    seg_max = logits.new_full((num_segments,) + tuple(logits.shape[1:]),
                              -torch.inf)
    seg_max = seg_max.index_reduce_(0, segment_ids, logits, "amax",
                                    include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - seg_max[segment_ids])
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / (denom[segment_ids] + 1e-16)


def scatter_nodes_to_dense(x: torch.Tensor, node_graph: torch.Tensor,
                           node_pos: torch.Tensor, num_graphs: int,
                           max_nodes: int) -> torch.Tensor:
    """Scatter flat node features [N, C] to dense [G, max_nodes, C].

    Positions beyond a graph's node count stay zero.  Nodes with
    ``pos >= max_nodes`` are dropped (they add zero into the last slot
    of the padding graph, as the JAX scatter does)."""
    C = x.shape[-1]
    ok = node_pos < max_nodes
    g = torch.where(ok, node_graph, num_graphs - 1)
    p = torch.where(ok, node_pos, max_nodes - 1)
    contrib = torch.where(ok[:, None], x, torch.zeros_like(x))
    dense = x.new_zeros((num_graphs * max_nodes, C))
    dense.index_add_(0, g * max_nodes + p, contrib)
    return dense.view(num_graphs, max_nodes, C)


def segment_topk_by_channel(x: torch.Tensor, segment_ids: torch.Tensor,
                            node_pos: torch.Tensor, num_segments: int,
                            max_nodes: int, k: int) -> torch.Tensor:
    """Per-graph top-k node rows ranked by the LAST channel, flattened to
    [G, k*C]; graphs with fewer than k nodes are zero-padded (PyG
    ``global_sort_pool``).

    Tied keys go lowest position first, as ``jax.lax.top_k`` orders them
    (a stable descending sort; ``torch.topk`` orders ties arbitrarily).
    In a molecule tied keys come from symmetric atoms whose rows are
    identical, so the output is the same either way, but the gradient
    reaches the atoms picked."""
    C = x.shape[-1]
    dense = scatter_nodes_to_dense(x, segment_ids, node_pos, num_segments,
                                   max_nodes)                   # [G, M, C]
    occupied = scatter_nodes_to_dense(
        x.new_ones((x.shape[0], 1)), segment_ids, node_pos, num_segments,
        max_nodes)[..., 0] > 0                                  # [G, M]
    keys = torch.where(occupied, dense[..., -1],
                       torch.full_like(dense[..., -1], -torch.inf))
    idx = torch.sort(keys, dim=1, descending=True,
                     stable=True).indices[:, :k]                # [G, k]
    rows = torch.gather(dense, 1, idx[..., None].expand(-1, -1, C))
    valid = torch.gather(occupied, 1, idx)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return rows.reshape(num_segments, k * C)
