"""Segment (scatter/gather) primitives.

The counterparts of the JAX package's ``ops/segment.py``.  All functions
assume the GraphBatch padding convention (padded edges point at padding
nodes), so no masking is needed: padded contributions land in padding
segments.  Index tensors are int64.

Every sum runs in one fixed order, as the JAX package's compiled sums do,
so a training run on the card repeats itself bit for bit: a
:class:`Segments` is the CSR of a segment-id array (``GraphBatch`` carries
those of its receivers, senders and node graphs, built on the host), and
its sums and the backward of its gathers go through the CSR-sum kernel
(``ops/kernels/segment_sum_csr.py``), never ``index_add_``'s float
atomics.  ``segment_sum``, ``segment_mean``, ``segment_count`` and
``segment_softmax`` take bare ids, as the JAX functions do, and build
their CSR on the ids' device first (a stable sort and a search, no host
synchronisation).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels.segment_sum_csr import csr_segment_sum, gather_rows


class Segments(NamedTuple):
    """Entries grouped into segments: ``ids`` [n] int64 the segment of
    each entry, and their CSR, ``rowptr`` [S+1] int32 and ``perm`` [n]
    int32 the entries in segment order (None: the ids ascend, entry k is
    slot k).  Every entry lies in a segment."""

    ids: torch.Tensor
    rowptr: torch.Tensor
    perm: Optional[torch.Tensor] = None

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """[S, ...] sums of ``data``'s rows (one per entry) by segment, in
        CSR order (in float32 for a lower-precision ``data``, rounded
        once); differentiable."""
        return csr_segment_sum(data, self.ids, self.rowptr, self.perm)

    def count(self) -> torch.Tensor:
        """Entries per segment (float32), from the row pointers."""
        return (self.rowptr[1:] - self.rowptr[:-1]).float()

    def mean(self, data: torch.Tensor) -> torch.Tensor:
        """Mean with zero for empty segments (torch_scatter 'mean')."""
        tot = self.sum(data)
        cnt = self.count().clamp(min=1.0)
        return tot / cnt.reshape((-1,) + (1,) * (tot.dim() - 1)).to(tot.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x.index_select(0, ids)``, x [S, ...]; its backward sums each
        segment's cotangents in CSR order."""
        return gather_rows(x, self.ids, self.rowptr, self.perm)


def segments_of(segment_ids: torch.Tensor, num_segments: int) -> Segments:
    """The :class:`Segments` of ids in [0, num_segments), built on their
    device: a stable sort (entries of a segment keep their order) and the
    row pointers by a search."""
    srt, order = torch.sort(segment_ids, stable=True)
    rowptr = torch.searchsorted(srt, torch.arange(
        num_segments + 1, device=srt.device, dtype=srt.dtype))
    return Segments(segment_ids, rowptr.to(torch.int32),
                    order.to(torch.int32))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``data``'s rows per segment, in float32 for a
    lower-precision ``data``, rounded once."""
    return segments_of(segment_ids, num_segments).sum(data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean with zero for empty segments (torch_scatter 'mean')."""
    return segments_of(segment_ids, num_segments).mean(data)


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Entries per segment (float32)."""
    return segments_of(segment_ids, num_segments).count()


def index_sum(data: torch.Tensor, rows: torch.Tensor,
              n: int) -> torch.Tensor:
    """``index_add_`` of ``data``'s rows into ``n`` rows: the sum of the
    kernels' plain versions, which run on the CPU, where it adds in index
    order."""
    return data.new_zeros((n,) + tuple(data.shape[1:])).index_add_(
        0, rows, data)


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
    max (0 for empty segments), divide by the segment sum plus 1e-16.
    The max is order-free; the sum and the gathers' backward run in CSR
    order."""
    segs = segments_of(segment_ids, num_segments)
    seg_max = logits.new_full((num_segments,) + tuple(logits.shape[1:]),
                              -torch.inf)
    seg_max = seg_max.index_reduce_(0, segment_ids, logits, "amax",
                                    include_self=True)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(logits - segs.gather(seg_max))
    return ex / (segs.gather(segs.sum(ex)) + 1e-16)


def scatter_nodes_to_dense(x: torch.Tensor, node_graph: torch.Tensor,
                           node_pos: torch.Tensor, num_graphs: int,
                           max_nodes: int) -> torch.Tensor:
    """Scatter flat node features [N, C] to dense [G, max_nodes, C].

    Positions beyond a graph's node count stay zero.  Nodes with
    ``pos >= max_nodes`` are dropped (they add zero into the last slot
    of the padding graph, as the JAX scatter does).

    ``index_add_`` cannot change bits here: every destination takes one
    row, except the padding graph's last slot, which also takes the
    dropped nodes' zeros (x + 0 is x in any order); its backward is a
    gather."""
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
    # torch.gather's backward adds with atomics, but the indices of a
    # graph's row are distinct (a sort's): each destination takes one value
    rows = torch.gather(dense, 1, idx[..., None].expand(-1, -1, C))
    valid = torch.gather(occupied, 1, idx)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return rows.reshape(num_segments, k * C)
