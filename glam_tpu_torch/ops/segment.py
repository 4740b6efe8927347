"""Segment (scatter/gather) primitives in plain torch.

The counterparts of the JAX package's ``ops/segment.py``.  All functions
assume the GraphBatch padding convention (padded edges point at padding
nodes), so no masking is needed: padded contributions land in padding
segments.  Index tensors are int64.

``segment_sum`` is ``index_add_``, except for inference on the card
(CUDA tensors, gradients off): there ``index_add_``'s float atomics sum
each segment in the order its entries land, so two forwards of one
checkpoint on one input differ in the last bits; instead each segment's
entries are summed in index order (``torch.segment_reduce``), the same
bits on every call.  Training keeps ``index_add_``, whose backward is a
gather.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, sorted_ids: bool = False) -> torch.Tensor:
    """Sum of ``data``'s rows per segment, in float32 for a
    lower-precision ``data`` (a bfloat16 or float16 sum rounds at every
    add, and on the card in another order at every call).  ``sorted_ids``
    says the ids ascend (node rows grouped by graph, as ``pad_graphs``
    lays them out): it spares the card's in-order path a sort."""
    if data.is_cuda and not torch.is_grad_enabled():
        return segment_sum_in_order(data, segment_ids, num_segments,
                                    sorted_ids)
    wide = data.float() if data.dtype in (torch.float16,
                                          torch.bfloat16) else data
    out = wide.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, wide).to(data.dtype)


_PIECE = 128


def segment_sum_in_order(data: torch.Tensor, segment_ids: torch.Tensor,
                         num_segments: int,
                         sorted_ids: bool = False) -> torch.Tensor:
    """``segment_sum`` with each segment's entries summed in index order
    (in float32 for a lower-precision ``data``): bitwise the same on
    every call.  The rows, sorted by segment, are cut into pieces of at
    most ``_PIECE`` rows of one segment; each piece is summed in order,
    then each segment's pieces in order (two ``segment_reduce`` calls,
    whose loops stay short where a segment is long, as the padding
    graph's and the padding node's are).  No host synchronisation."""
    n = segment_ids.shape[0]
    dev = segment_ids.device
    ids, rows = segment_ids, data
    if not sorted_ids:
        ids, order = torch.sort(segment_ids, stable=True)
        rows = data.index_select(0, order)
    wide = rows.float() if rows.dtype in (torch.float16,
                                          torch.bfloat16) else rows
    # piece starts: a segment's first row, and every _PIECE-th row of it
    seg = torch.arange(num_segments + 1, device=dev, dtype=ids.dtype)
    first = torch.searchsorted(ids, seg)               # [S + 1]
    local = torch.arange(n, device=dev) - first.index_select(0, ids)
    starts = local % _PIECE == 0
    piece = torch.cumsum(starts, 0) - 1                # piece of each row
    most = num_segments + -(-n // _PIECE)              # pieces at most
    unused = num_segments                              # a dummy segment
    piece_seg = torch.full((most,), unused, device=dev, dtype=ids.dtype)
    piece_seg.scatter_(0, piece, ids)
    pieces = torch.searchsorted(
        piece, torch.arange(most + 1, device=dev, dtype=piece.dtype))
    part = torch.segment_reduce(wide, "sum", lengths=pieces[1:] - pieces[:-1],
                                axis=0, unsafe=True, initial=0)
    bounds = torch.searchsorted(piece_seg, torch.arange(
        num_segments + 2, device=dev, dtype=ids.dtype))
    out = torch.segment_reduce(part, "sum", lengths=bounds[1:] - bounds[:-1],
                               axis=0, unsafe=True, initial=0)
    return out[:num_segments].to(data.dtype)


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
