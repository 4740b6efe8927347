"""Static-shape batched graph container.

Variable-size molecular graphs are packed into one fixed-shape
:class:`GraphBatch`, the layout of the JAX package's ``data/graph.py``:

  * one extra graph slot (the last one) owns all padding nodes and edges;
  * padded edges point from the last node to the last node and carry
    zero edge features, so segment reductions over ``node_graph`` /
    ``receivers`` need no masking.

On top of that layout the batch carries a receiver-sorted CSR of the
real edges (``csr_rowptr``, ``csr_snd``, ``csr_eid``), built on the
host.  The triplet-attention kernels walk it one receiver row at a time.
Padded edges are left out of its rows: their edge features are zero, so
their messages are zero and leaving them out changes no output.  Its
slot arrays are padded to the edge budget all the same, so that every
batch of a loader has the same shapes (what a CUDA graph of a step
needs): the E - E_real slots past ``csr_rowptr[-1]`` belong to no row,
their senders are the last node and their edge ids E_real..E-1, the
padded edges in order.  The real slots come first and their edge ids
are a permutation of [0, E_real).

Other convs do see the padded edges: at the last node, softmax attention
over them gives that node's own projection (``TripletMessageLight``) and
``NNConv`` averages their messages.  ``padded_csr`` and ``self_loop_csr``
are the CSRs over every edge slot (and GAT's self-loops) that the
segment-softmax kernel walks, built on the host with the batch
(``pad_rowptr``, ``loop_rowptr``, ``loop_idx``).  Two more CSRs group
rows for the fixed-order sums (``ops/segment.py``): ``sender_csr`` every
edge slot by sender (``snd_rowptr``, ``snd_eid``; the padded edges in
the last node's row, as ``pad_rowptr`` has them, and listed last: its
first E_real slots are the real edges, so kernel B's sums of d_xp and
d_a_j end at ``csr_rowptr[-1]``), and ``graph_rowptr``
the node rows by graph (the prefix sums of ``n_node``: ``pad_graphs``
lays each graph's nodes out contiguously, in graph order).
``by_receiver``, ``by_sender`` and ``by_graph`` give them as
:class:`~glam_tpu_torch.ops.segment.Segments`.

Index dtypes: the padded edge and node index arrays are int64 (what torch
indexing takes); the CSR arrays are int32 (what the kernel takes).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.segment import Segments


class GraphArrays(NamedTuple):
    """A single un-padded graph as host numpy arrays (featurizer output)."""

    nodes: np.ndarray        # [n, Fn] float32
    edges: np.ndarray        # [e, Fe] float32
    senders: np.ndarray      # [e] int32
    receivers: np.ndarray    # [e] int32
    y: np.ndarray            # [T] float32
    smi: str = ""


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A batch of graphs padded to static shapes.

    N = padded node count, E = padded edge count, G = padded graph count
    (last slot = padding graph), E_real = real edge count.
    """

    nodes: torch.Tensor        # [N, Fn] float32
    edges: torch.Tensor        # [E, Fe] float32
    senders: torch.Tensor      # [E] int64
    receivers: torch.Tensor    # [E] int64
    node_graph: torch.Tensor   # [N] int64 graph id of each node
    node_pos: torch.Tensor     # [N] int64 position of node within its graph
    n_node: torch.Tensor       # [G] int64 node count per graph (incl. pad)
    node_mask: torch.Tensor    # [N] bool
    edge_mask: torch.Tensor    # [E] bool
    graph_mask: torch.Tensor   # [G] bool
    y: torch.Tensor            # [G, T] float32
    csr_rowptr: torch.Tensor   # [N + 1] int32 row starts into csr_snd
    csr_snd: torch.Tensor      # [E] int32 sender of each sorted edge
    csr_eid: torch.Tensor      # [E] int32 original edge id
    pad_rowptr: torch.Tensor   # [N + 1] int32 csr_rowptr, last entry E
    loop_rowptr: torch.Tensor  # [N + 1] int32 self_loop_csr's row starts
    loop_idx: torch.Tensor     # [E + N] int32 self_loop_csr's entries
    snd_rowptr: torch.Tensor   # [N + 1] int32 sender_csr's row starts
    snd_eid: torch.Tensor      # [E] int32 edge ids by sender, pads last
    graph_rowptr: torch.Tensor  # [G + 1] int32 node rows by graph

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.n_node.shape[0]

    @property
    def num_real_edges(self) -> int:
        """E_real (reads ``csr_rowptr[-1]``: on the card, a host
        synchronisation)."""
        return int(self.csr_rowptr[-1])

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    def cast(self, dtype: torch.dtype) -> "GraphBatch":
        """The batch with its float features (nodes, edges) in
        ``dtype``; itself when they already are."""
        if self.nodes.dtype == dtype and self.edges.dtype == dtype:
            return self
        return dataclasses.replace(self, nodes=self.nodes.to(dtype),
                                   edges=self.edges.to(dtype))

    @property
    def padded_csr(self):
        """Receiver CSR of every edge slot, padded ones included: (rowptr
        [N+1], idx [E]) int32.  Padded edges follow the real ones and all
        point at the last node, so they extend its row."""
        return self.pad_rowptr, self.csr_eid

    @property
    def by_receiver(self) -> Segments:
        """Every edge slot by receiver (``padded_csr``)."""
        return Segments(self.receivers, self.pad_rowptr, self.csr_eid)

    @property
    def by_sender(self) -> Segments:
        """Every edge slot by sender (``sender_csr``)."""
        return Segments(self.senders, self.snd_rowptr, self.snd_eid)

    @property
    def by_graph(self) -> Segments:
        """Node rows by graph: in order, so no permutation."""
        return Segments(self.node_graph, self.graph_rowptr)

    @property
    def self_loop_csr(self):
        """``padded_csr`` with a self-loop first in every row: (rowptr
        [N+1], idx [E+N]) int32, where entry E + r is node r's loop (GAT
        appends N loops to its E edges)."""
        return self.loop_rowptr, self.loop_idx


def graph_csr(n_node: torch.Tensor, num_nodes: int):
    """Node rows grouped by graph: (rowptr [G+1] = the prefix sums of
    ``n_node``, idx [N] = 0..N-1) int32.  ``pad_graphs`` lays out each
    graph's nodes contiguously, in graph order."""
    rowptr = torch.zeros(n_node.shape[0] + 1, dtype=torch.int32,
                         device=n_node.device)
    rowptr[1:] = torch.cumsum(n_node, 0)
    return rowptr, torch.arange(num_nodes, dtype=torch.int32,
                                device=n_node.device)


def budget_csr(rowptr: np.ndarray, snd: np.ndarray, eid: np.ndarray,
               num_edges: int):
    """The real edges' CSR (``receiver_csr``) with its slots padded to
    the edge budget, and the CSRs over every slot: (csr_snd [E], csr_eid
    [E], pad_rowptr [N+1], loop_rowptr [N+1], loop_idx [E+N]), all int32.
    The slots past ``rowptr[-1]`` hold the padded edges E_real..E-1, each
    sent by the last node; ``pad_rowptr`` puts them in the last node's
    row, and the self-loop CSR adds node r's loop, entry E + r, first in
    row r."""
    n = rowptr.shape[0] - 1
    e_real = int(rowptr[-1])
    pad = np.arange(e_real, num_edges, dtype=np.int32)
    csr_snd = np.concatenate([snd.astype(np.int32),
                              np.full(pad.shape, n - 1, np.int32)])
    csr_eid = np.concatenate([eid.astype(np.int32), pad])
    pad_rowptr = rowptr.astype(np.int32)
    pad_rowptr[-1] = num_edges
    rows = np.repeat(np.arange(n), np.diff(pad_rowptr))
    loop_rowptr = (pad_rowptr + np.arange(n + 1)).astype(np.int32)
    loop_idx = np.empty(num_edges + n, np.int32)
    loop_idx[np.arange(num_edges) + rows + 1] = csr_eid
    loop_idx[loop_rowptr[:-1]] = num_edges + np.arange(n)
    return csr_snd, csr_eid, pad_rowptr, loop_rowptr, loop_idx


def sender_csr(senders: np.ndarray, num_nodes: int):
    """Sender-sorted CSR of every edge slot: (rowptr [N+1], eid [E]),
    int32.  Edges of one sender keep their order, so the padded edges
    (sent by the last node, after the real ones) end its row and are
    listed last, past every real edge: the contract the triplet
    backward's sums, which end at the real edges, rely on."""
    order = np.argsort(senders, kind="stable")
    rowptr = np.zeros((num_nodes + 1,), np.int32)
    np.cumsum(np.bincount(senders, minlength=num_nodes), out=rowptr[1:])
    return rowptr, order.astype(np.int32)


def receiver_csr(senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int):
    """Receiver-sorted CSR of an edge list: (rowptr [N+1], snd [E],
    eid [E]), all int32.  Edges of one receiver keep their input order."""
    order = np.argsort(receivers, kind="stable")
    counts = np.bincount(receivers, minlength=num_nodes)
    rowptr = np.zeros((num_nodes + 1,), np.int32)
    np.cumsum(counts, out=rowptr[1:])
    return (rowptr, senders[order].astype(np.int32),
            order.astype(np.int32))


def pad_graphs(graphs: Sequence[GraphArrays], num_graphs: int,
               num_nodes: int, num_edges: int,
               num_tasks: int | None = None, node_dim: int | None = None,
               edge_dim: int | None = None) -> GraphBatch:
    """Pack ``graphs`` into one static-shape :class:`GraphBatch` on the
    CPU.

    ``num_graphs`` counts only real graph slots; one extra padding-graph
    slot is appended, so the result has ``G = num_graphs + 1`` graphs.
    Raises if the batch does not fit the requested budget.  An empty
    ``graphs`` gives an all-padding batch (graph_mask all False), the
    data-parallel loaders' trailing sub-batches; it needs ``node_dim``,
    ``edge_dim`` and ``num_tasks``.
    """
    if not graphs and (node_dim is None or num_tasks is None):
        raise ValueError("an empty batch needs node_dim and num_tasks")
    g_real = len(graphs)
    if g_real > num_graphs:
        raise ValueError(f"{g_real} graphs > budget {num_graphs}")
    tot_n = sum(g.nodes.shape[0] for g in graphs)
    tot_e = sum(g.senders.shape[0] for g in graphs)
    if tot_n > num_nodes or tot_e > num_edges:
        raise ValueError(
            f"batch needs ({tot_n} nodes, {tot_e} edges) > budget "
            f"({num_nodes}, {num_edges})")
    if graphs:
        fn = graphs[0].nodes.shape[1]
        fe = graphs[0].edges.shape[1] if graphs[0].edges.ndim == 2 else 0
    else:
        fn, fe = node_dim, edge_dim or 0
    nt = num_tasks if num_tasks is not None else graphs[0].y.shape[-1]
    G = num_graphs + 1

    nodes = np.zeros((num_nodes, fn), np.float32)
    edges = np.zeros((num_edges, fe), np.float32)
    senders = np.full((num_edges,), num_nodes - 1, np.int64)
    receivers = np.full((num_edges,), num_nodes - 1, np.int64)
    node_graph = np.full((num_nodes,), G - 1, np.int64)
    node_pos = np.zeros((num_nodes,), np.int64)
    n_off = e_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.nodes.shape[0], g.senders.shape[0]
        nodes[n_off:n_off + n] = g.nodes
        if e:
            edges[e_off:e_off + e] = g.edges
            senders[e_off:e_off + e] = g.senders + n_off
            receivers[e_off:e_off + e] = g.receivers + n_off
        node_graph[n_off:n_off + n] = gi
        node_pos[n_off:n_off + n] = np.arange(n)
        n_off += n
        e_off += e
    # padding nodes belong to the padding graph; positions restart
    node_pos[n_off:] = np.arange(num_nodes - n_off)
    node_mask = np.zeros((num_nodes,), bool)
    node_mask[:n_off] = True
    edge_mask = np.zeros((num_edges,), bool)
    edge_mask[:e_off] = True

    n_node = np.zeros((G,), np.int64)
    y = np.full((G, nt), -1.0, np.float32)
    for gi, g in enumerate(graphs):
        n_node[gi] = g.nodes.shape[0]
        y[gi] = np.asarray(g.y, np.float32).reshape(-1)[:nt]
    n_node[G - 1] = num_nodes - n_off
    graph_mask = np.zeros((G,), bool)
    graph_mask[:g_real] = True

    rowptr, csr_snd, csr_eid = receiver_csr(senders[:e_off],
                                            receivers[:e_off], num_nodes)
    csr_snd, csr_eid, pad_rowptr, loop_rowptr, loop_idx = budget_csr(
        rowptr, csr_snd, csr_eid, num_edges)
    snd_rowptr, snd_eid = sender_csr(senders, num_nodes)
    graph_rowptr = np.zeros((G + 1,), np.int32)
    np.cumsum(n_node, out=graph_rowptr[1:])
    t = torch.from_numpy
    return GraphBatch(
        nodes=t(nodes), edges=t(edges), senders=t(senders),
        receivers=t(receivers), node_graph=t(node_graph),
        node_pos=t(node_pos), n_node=t(n_node), node_mask=t(node_mask),
        edge_mask=t(edge_mask), graph_mask=t(graph_mask), y=t(y),
        csr_rowptr=t(rowptr), csr_snd=t(csr_snd), csr_eid=t(csr_eid),
        pad_rowptr=t(pad_rowptr), loop_rowptr=t(loop_rowptr),
        loop_idx=t(loop_idx), snd_rowptr=t(snd_rowptr), snd_eid=t(snd_eid),
        graph_rowptr=t(graph_rowptr))
