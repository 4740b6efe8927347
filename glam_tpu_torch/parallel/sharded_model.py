"""One giant graph's tower, node-sharded over ranks: the counterpart of
the JAX package's ``parallel/sharded_model.py``.

The protein contact-map graph of a DTI pair (L ~ 900 residues) is cut
into D contiguous node shards, one per rank of a ``torch.distributed``
process group.  Each rank runs the tower over its shard's rows and a
small halo table of the boundary rows its edges read, and the norms,
readouts and the pair model's fusion statistics reduce across the ranks.

  * :func:`shard_inputs` (host numpy, equal to the JAX package's bit for
    bit): node and edge shards, the halo plan ('a2a': one all_to_all at
    the largest boundary; 'ring': one send a ring distance at that
    distance's budget; 'auto': ring where it halves the rows), node
    masks and GCN's global-degree normalisation.
  * :func:`make_stochastic_inputs`: the protein tower's training noise
    (graph dropout keep mask, train-mode RReLU slopes) drawn from a
    ``torch.Generator`` over the global (steps, N, C) shape, so a shard
    count does not change the draws.
  * :func:`pack_shards`: one rank's rows of B graphs (the pairs of one
    optimizer step) packed into one local graph: its halo table then
    holds every pair's boundary rows, so a message step issues one halo
    collective for the batch.  The CSR of the shard's real edges over
    the table rows is built here, on the host.
  * :class:`ShardedTower`: the tower's forward over a dense ``_Tower``'s
    own parameters (no copy): pre-linear, the five norms with
    all-reduced statistics (BatchNorm: batch statistics in ``train()``
    mode, with the momentum-0.1 update of the module's running ones, the
    running ones in ``eval()``), the five convs over the shard's
    ``[local ; halo]`` table and the three readouts.  The convs run the
    kernels of their dense counterparts (``nn/convs.py``):
    ``_TripletMessage`` kernels A and B (the table as ``xp``, the halo
    rows empty CSR rows, the first rows of the output kept),
    ``_TripletMessageLight`` and ``_GATConv`` kernel C both ways (GAT's
    self-loops over the local rows, loop first); ``_GCNConv`` and
    ``_NNConv`` plain torch.  Every gather (the halo sends, the senders'
    and receivers' rows) is a ``Segments.gather``, whose backward sums
    each row's cotangents with the CSR-sum kernel in slot order, and
    NNConv's and GCN's sums over receivers are ``Segments.sum``: no
    ``index_add_`` atomics.
  * :func:`make_sharded_forward` / :func:`make_sharded_train_step` over
    a dense ``Architecture``, :func:`make_sharded_pair_forward` /
    :func:`make_sharded_pair_train_step` over a dense
    ``PairArchitecture(hetero=True)``: its molecule tower runs whole on
    every rank, its protein tower sharded.

Gradients come from each rank's own backward through the collectives of
``parallel/distributed.py`` (f, g and their transposes): every rank ends
with the whole gradient of every parameter.  Every sum runs in a fixed
order, the all-reduces' in rank order, so a step's bits do not depend on
the run, and a run repeats and resumes bit for bit, as the JAX trainer
promises (``glam_tpu/train/sharded_pair_trainer.py:733-757``).  The
dense model's ``state_dict`` is the checkpoint, so a sharded-trained
model serves unchanged.

The halo exchange overlaps the work that does not read it, as the JAX
package's ``run_tower`` lets XLA's scheduler overlap it
(``glam_tpu/parallel/sharded_model.py:652-689``).  Each conv issues its
halo as soon as the rows it sends exist (``distributed.exchange_start``,
under nccl on NCCL's stream; in a captured step a branch of the graph),
computes the terms that do not read the table, and only then waits for
it (``exchange_finish``); the backward issues the reverse exchange and
waits for it around the same terms' backward.  Each message step's
fusion statistics are deferred: their products and sums run while the
next step's halo is in flight, their two all-reduces after it has
arrived (so that one NCCL operation is in flight at a time), the last
step's after the loop.  ``GLAM_SHARDED_OVERLAP=0``, read when a tower is
built, turns both off (each exchange waited for where it is issued, each
step's statistics taken after it).  The autograd graph is the same
either way, its nodes made in the same order (the statistics read each
step's output through an alias made right after it), so that autograd
adds every gradient's terms in one order: the outputs and gradients are
bitwise equal either way.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.graph import GraphBatch, receiver_csr, sender_csr
from ..nn.activations import (RRELU_LOWER, RRELU_UPPER, Activation,
                              activation_key, celu)
from ..nn.cells import gru_cell, lstm_cell
from ..nn.convs import NO_GRU_CONVS
from ..ops.kernels.segment_softmax_spmm import segment_softmax_spmm
from ..ops.kernels.triplet_fused import triplet_attention
from ..ops.segment import Segments, scatter_nodes_to_dense
from . import distributed as dd
from .graph_partition import (build_halo_exchange, build_halo_exchange_ring,
                              split_large_graph)

NORMS = ("_None", "_PairNorm", "_GraphSizeNorm", "_LayerNorm", "_BatchNorm")


def shard_inputs(nodes: np.ndarray, edges: np.ndarray,
                 senders: np.ndarray, receivers: np.ndarray,
                 n_parts: int, halo: str = "a2a",
                 node_budget: int = 0, edge_budget: int = 0,
                 halo_budget: int = 0, ring_budgets=None):
    """Host partition of one graph over ``n_parts`` shards: (nodes
    [D, Nl, F], edges [D, El, Fe], senders_local [D, El] (into each
    shard's [local ; halo] table), receivers_local [D, El], edge_mask
    [D, El], node_mask [D, Nl], send_idx, edge_norm [D, El], self_norm
    [D, Nl]).

    ``halo``: 'a2a' (send_idx [D, D, H]), 'ring' (a tuple of [D, H_k],
    k = 1..D-1) or 'auto' (ring when its rows are under half of a2a's
    D*H).  ``node_budget``, ``edge_budget``, ``halo_budget`` and
    ``ring_budgets`` are floors on the padded shapes, so that graphs of
    different sizes share one shape.  edge_norm and self_norm are GCN's
    symmetric normalisation over global degrees (in-degree + self-loop).
    """
    nsh, esh, sg, rl, emask = split_large_graph(
        nodes, edges, senders, receivers, n_parts,
        node_budget=node_budget, edge_budget=edge_budget)
    N = nodes.shape[0]
    Nl = nsh.shape[1]
    if halo == "auto":
        ring_idx, budgets, ring_snd = build_halo_exchange_ring(sg, emask, Nl)
        a2a_idx, _, a2a_snd, H = build_halo_exchange(
            sg, emask, Nl, halo_budget=halo_budget)
        if 2 * sum(budgets) < n_parts * H:
            send_idx, snd_l = ring_idx, ring_snd
        else:
            send_idx, snd_l = a2a_idx, a2a_snd
    elif halo == "ring":
        send_idx, _, snd_l = build_halo_exchange_ring(
            sg, emask, Nl, budget_floors=ring_budgets)
    elif halo == "a2a":
        send_idx, _, snd_l, _ = build_halo_exchange(
            sg, emask, Nl, halo_budget=halo_budget)
    else:
        raise ValueError(
            f"halo must be 'a2a', 'ring' or 'auto', got {halo!r}")
    nmask = np.zeros((n_parts, Nl), bool)
    for d in range(n_parts):
        nmask[d, :max(0, min(Nl, N - d * Nl))] = True
    deg = np.bincount(receivers, minlength=N).astype(np.float32) + 1.0
    dinv = 1.0 / np.sqrt(deg)
    enorm = np.zeros(emask.shape, np.float32)
    self_norm = np.zeros((n_parts, Nl), np.float32)
    offset = (np.arange(n_parts) * Nl)[:, None]
    enorm[emask] = dinv[sg[emask]] * dinv[(rl + offset)[emask]]
    for d in range(n_parts):
        n_real = max(0, min(Nl, N - d * Nl))
        dd_ = dinv[d * Nl:d * Nl + n_real]
        self_norm[d, :n_real] = dd_ * dd_
    return nsh, esh, snd_l, rl, emask, nmask, send_idx, enorm, self_norm


def corpus_budgets(graphs, n_parts: int, halo: str = "a2a"):
    """Shape floors under which every graph of ``graphs`` (each with
    ``nodes``, ``edges``, ``senders``, ``receivers``) shards to one
    padded shape: (node budget, edge slots, a2a halo budget H, ring
    budgets, the plan).  The node budget comes first (the shard
    boundaries depend on it); each distinct graph is then planned at it
    for the edge-slot and halo maxima.  ``halo='auto'`` resolves here for
    the whole corpus: 'ring' when its rows are under half of a2a's D*H."""
    want_ring = halo in ("ring", "auto")
    want_a2a = halo in ("a2a", "auto")
    nb = max(g.nodes.shape[0] for g in graphs)
    seen, eb, hb = set(), 0, 0
    ring = [0] * (n_parts - 1)
    for g in graphs:
        if id(g) in seen:
            continue
        seen.add(id(g))
        nsh, esh, sg, _, em = split_large_graph(
            g.nodes, g.edges, g.senders, g.receivers, n_parts,
            node_budget=nb)
        eb = max(eb, esh.shape[1])
        if want_ring:
            _, budgets, _ = build_halo_exchange_ring(sg, em, nsh.shape[1])
            ring = [max(a, b) for a, b in zip(ring, budgets)]
        if want_a2a:
            _, _, _, H = build_halo_exchange(sg, em, nsh.shape[1])
            hb = max(hb, H)
    if halo == "auto":
        halo = "ring" if 2 * sum(ring) < n_parts * hb else "a2a"
    return nb, eb, hb, tuple(ring), halo


def shard_at(graph, n_parts: int, rank: int, budgets) -> tuple:
    """Rank ``rank``'s slice of ``graph``'s :func:`shard_inputs` at the
    :func:`corpus_budgets` ``budgets`` (numpy)."""
    nb, eb, hb, ring, halo = budgets
    kw = dict(node_budget=nb, edge_budget=eb)
    if halo == "ring":
        kw.update(halo="ring", ring_budgets=ring)
    else:
        kw.update(halo="a2a", halo_budget=hb)
    return shard_of(shard_inputs(graph.nodes, graph.edges, graph.senders,
                                 graph.receivers, n_parts, **kw), rank)


def make_stochastic_inputs(generator: torch.Generator, n_nodes: int,
                           hid_dim: int, message_steps: int, n_parts: int,
                           rate: float = 0.2):
    """The protein tower's training noise: (drop [D, S, Nl, C], slope
    [D, S, Nl, C]) float32 CPU tensors.

    The keep mask (1/(1-rate) where kept, inverted dropout) and then the
    RReLU slopes (U[1/8, 1/3] an element) are drawn from ``generator``
    (a CPU one) over the global ``(message_steps, n_nodes, hid_dim)``
    shape, so the same generator state gives the same noise at any shard
    count; at rate 0 no mask is drawn.  Global node ``d*Nl + slot`` goes
    to shard d, as :func:`shard_inputs` lays the nodes out; padding slots
    get keep 1 and the mean slope."""
    S, N, C = message_steps, n_nodes, hid_dim
    if rate > 0.0:
        keep = 1.0 - rate
        u = torch.rand((S, N, C), generator=generator)
        drop_g = (u < keep).to(torch.float32) / keep
    else:
        drop_g = torch.ones((S, N, C))
    slope_g = torch.empty((S, N, C)).uniform_(RRELU_LOWER, RRELU_UPPER,
                                              generator=generator)
    Nl = -(-N // n_parts)
    Nl = -(-Nl // 8) * 8
    pad = n_parts * Nl - N
    drop = torch.cat([drop_g, torch.ones((S, pad, C))], 1)
    slope = torch.cat([slope_g, torch.full(
        (S, pad, C), (RRELU_LOWER + RRELU_UPPER) / 2.0)], 1)
    return (drop.view(S, n_parts, Nl, C).transpose(0, 1).contiguous(),
            slope.view(S, n_parts, Nl, C).transpose(0, 1).contiguous())


# ------------------------------------------------------------ one shard
@dataclasses.dataclass
class Shard:
    """One rank's rows of B graphs packed into one local graph (see
    :func:`pack_shards`); R = B * Nl rows, T table rows, E edge slots,
    the real ones first.  Every array has a shape fixed by the corpus
    budgets (a CUDA graph of a step takes every protein of a corpus):
    the CSRs' slots are padded to E, the pads past ``csr_rowptr[-1]``
    (kernels A and B read E_real there) and, for kernel C, in an extra
    row R whose output is dropped.  The gathers' CSRs list every slot,
    pads included, in the row its id names, slot order within a row
    (:attr:`sender_segments`, :attr:`receiver_segments`,
    :meth:`send_segments`)."""

    nodes: torch.Tensor        # [R, F]
    edges: torch.Tensor        # [E, Fe]
    senders: torch.Tensor      # [E] int64, rows of the [local ; halo] table
    receivers: torch.Tensor    # [E] int64, local rows
    edge_mask: torch.Tensor    # [E] bool
    node_mask: torch.Tensor    # [R] bool
    edge_norm: torch.Tensor    # [E]
    self_norm: torch.Tensor    # [R]
    send_idx: Optional[torch.Tensor]  # a2a: [D, B*H] int64 local rows
    ring: Optional[Tuple[torch.Tensor, ...]]  # ring: [B*H_k] a distance
    csr_rowptr: torch.Tensor   # [T + 1] int32, real edges by receiver
    csr_snd: torch.Tensor      # [E] int32 table row of each (pads: T - 1)
    csr_eid: torch.Tensor      # [E] int32 edge slot of each (pads: E_real..)
    pad_rowptr: torch.Tensor   # [R + 2] int32, csr_rowptr's local rows and
    #                            a last row R of the E - E_real pads
    loop_rowptr: torch.Tensor  # [R + 2] int32, GAT's: a loop, then edges;
    #                            the last row R the pads
    loop_idx: torch.Tensor     # [E + R] int32; E + r is row r's loop
    snd_rowptr: torch.Tensor   # [T + 1] int32, every slot by sender
    snd_perm: torch.Tensor     # [E] int32, the slots in that order
    rcv_rowptr: torch.Tensor   # [R + 1] int32, every slot by receiver
    rcv_perm: torch.Tensor     # [E] int32
    send_rowptr: Tuple[torch.Tensor, ...]  # [R + 1] int32 the sent rows':
    send_perm: Tuple[torch.Tensor, ...]    # a2a one, ring one a distance
    graph_nodes: torch.Tensor  # [B] float32, each graph's real nodes
    n_pairs: int
    n_local: int
    table_rows: int

    def to(self, device) -> "Shard":
        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            if isinstance(v, tuple):
                return tuple(t.to(device) for t in v)
            return v
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    @property
    def sender_segments(self) -> Segments:
        """Every edge slot by its sender's row of the [local ; halo]
        table."""
        return Segments(self.senders, self.snd_rowptr, self.snd_perm)

    @property
    def receiver_segments(self) -> Segments:
        """Every edge slot by its receiver's local row."""
        return Segments(self.receivers, self.rcv_rowptr, self.rcv_perm)

    def send_segments(self) -> List[Segments]:
        """The halo sends' local rows (a2a: ``send_idx`` flat; ring: one
        a distance), each by the row it reads."""
        ids = [self.send_idx.reshape(-1)] if self.ring is None \
            else list(self.ring)
        return [Segments(i, r, p) for i, r, p in
                zip(ids, self.send_rowptr, self.send_perm)]

    @property
    def halo_sends(self) -> int:
        """The sends of a message step's halo exchange: a2a's one, or the
        ring's nonempty distances."""
        return 1 if self.ring is None else sum(
            int(idx.numel() > 0) for idx in self.ring)

    @property
    def halo_rows(self) -> int:
        """Rows this rank receives a halo exchange."""
        return self.table_rows - self.n_pairs * self.n_local


def shard_of(arrays, rank: int):
    """Rank ``rank``'s slice of :func:`shard_inputs`' arrays (the ring
    plan's tuple sliced per distance), as numpy, and the graph's real
    node count over every shard (the statistics' counts, known on the
    host, so that no collective computes them)."""
    out = []
    for a in arrays:
        if isinstance(a, tuple):
            out.append(tuple(np.asarray(x[rank]) for x in a))
        else:
            out.append(np.asarray(a[rank]))
    return tuple(out) + (int(np.asarray(arrays[5]).sum()),)


def pack_shards(per_graph: Sequence[tuple], n_parts: int) -> Shard:
    """One rank's :func:`shard_of` slices of B graphs (all at one padded
    shape and one plan kind) packed into one :class:`Shard` on the CPU.

    Graph b's local rows become rows [b*Nl, (b+1)*Nl).  The halo table
    is [local (B*Nl) ; for each source shard (a2a) or ring distance
    (ring), graph 0's rows, graph 1's, ...], so one exchange ships every
    graph's rows; senders are remapped into it.  Real edges come first
    (kernel B's invariant), then the padding slots."""
    B = len(per_graph)
    nodes, edges, snd, rcv, emask, nmask, send, enorm, snorm, counts = zip(
        *per_graph)
    Nl = nodes[0].shape[0]
    R = B * Nl
    ring = isinstance(send[0], tuple)
    if ring:
        budgets = [idx.shape[0] for idx in send[0]]
    else:
        H = send[0].shape[1]
        budgets = [H] * n_parts
    offs = np.concatenate([[0], np.cumsum(budgets)])
    snd_p = []
    for b in range(B):
        s = snd[b].astype(np.int64)
        out = s + b * Nl
        halo = s >= Nl
        j = s[halo] - Nl
        sec = np.searchsorted(offs, j, side="right") - 1   # source/distance
        slot = j - offs[sec]
        out[halo] = R + B * offs[sec] + b * np.asarray(budgets)[sec] + slot
        snd_p.append(out)
    snd_p = np.concatenate(snd_p)
    rcv_p = np.concatenate([rcv[b].astype(np.int64) + b * Nl
                            for b in range(B)])
    em = np.concatenate(emask)
    order = np.concatenate([np.flatnonzero(em), np.flatnonzero(~em)])
    snd_p, rcv_p, em = snd_p[order], rcv_p[order], em[order]
    edges_p = np.concatenate(edges)[order]
    enorm_p = np.concatenate(enorm)[order]
    T = R + B * int(offs[-1])
    n_real = int(em.sum())
    rowptr, csr_snd, csr_eid = receiver_csr(snd_p[:n_real],
                                            rcv_p[:n_real], T)
    # GAT: row r's loop (entry E + r) first, then its edges in CSR order
    E = em.shape[0]
    in_deg = np.diff(rowptr[:R + 1])
    loop_ptr = np.zeros(R + 1, np.int32)
    np.cumsum(in_deg + 1, out=loop_ptr[1:])
    loop_idx = np.empty(n_real + R, np.int32)
    loop_idx[loop_ptr[:-1]] = E + np.arange(R)
    rows = np.repeat(np.arange(R), in_deg)
    loop_idx[np.arange(n_real) + rows + 1] = csr_eid
    # the slots padded to E: past the rows (A and B), or in row R (C)
    pads = np.arange(n_real, E, dtype=np.int32)
    csr_snd = np.concatenate([csr_snd, np.full(pads.shape, T - 1,
                                               np.int32)])
    csr_eid = np.concatenate([csr_eid, pads])
    loop_idx = np.concatenate([loop_idx, pads])
    pad_rowptr = np.append(rowptr[:R + 1], E).astype(np.int32)
    loop_ptr = np.append(loop_ptr, E + R).astype(np.int32)
    if ring:
        send_t, ring_t = None, tuple(
            torch.from_numpy(np.concatenate(
                [send[b][k].astype(np.int64) + b * Nl for b in range(B)]))
            for k in range(n_parts - 1))
        sent = [r.numpy() for r in ring_t]
    else:
        send_t = torch.from_numpy(np.concatenate(
            [send[b].astype(np.int64) + b * Nl for b in range(B)], 1))
        ring_t = None
        sent = [send_t.numpy().reshape(-1)]
    # the gathers' CSRs: a stable sort keeps a row's slots in slot order
    snd_rowptr, snd_perm = sender_csr(snd_p, T)
    rcv_rowptr, rcv_perm = sender_csr(rcv_p, R)
    send_csrs = [sender_csr(ids, R) for ids in sent]
    t = torch.from_numpy
    return Shard(
        nodes=t(np.concatenate(nodes).astype(np.float32)),
        edges=t(np.ascontiguousarray(edges_p, np.float32)),
        senders=t(snd_p), receivers=t(rcv_p), edge_mask=t(em),
        node_mask=t(np.concatenate(nmask)),
        edge_norm=t(np.ascontiguousarray(enorm_p, np.float32)),
        self_norm=t(np.concatenate(snorm).astype(np.float32)),
        send_idx=send_t, ring=ring_t, csr_rowptr=t(rowptr),
        csr_snd=t(csr_snd), csr_eid=t(csr_eid), pad_rowptr=t(pad_rowptr),
        loop_rowptr=t(loop_ptr),
        loop_idx=t(loop_idx), snd_rowptr=t(snd_rowptr),
        snd_perm=t(snd_perm), rcv_rowptr=t(rcv_rowptr),
        rcv_perm=t(rcv_perm),
        send_rowptr=tuple(t(r) for r, _ in send_csrs),
        send_perm=tuple(t(p) for _, p in send_csrs),
        graph_nodes=torch.tensor(counts, dtype=torch.float32), n_pairs=B,
        n_local=Nl, table_rows=T)


def _act(name: str) -> Activation:
    """The activation in eval mode (RReLU's mean slope)."""
    return Activation(name).eval()


# ------------------------------------------------------------ the tower
class ShardedTower:
    """The forward of a dense ``_Tower`` (``nn/model.py``) over a
    :class:`Shard`, reading the tower's parameters and BatchNorm buffers
    in place.  ``__call__(shard, noise=None, fusion=None, bn_weight=None)``
    -> (pooled [B, k*C] replicated, fusion statistics [B, S, 2] or None).

    ``noise``: (drop, slope) [S, R, C] from :func:`make_stochastic_inputs`
    (dropout after the norm, as MessageBlock's; the slopes apply when
    graph_act is RReLU).  ``fusion``: (the molecule tower's node states
    per graph [S, B, M, C], their mask [B, M]), for the pair model's
    per-step [max, mean] of the cross-graph dot products.
    ``bn_weight`` [B]: each graph's weight in BatchNorm's joint batch
    statistics (0 for a padding repeat)."""

    def __init__(self, tower, cfg, block: str, readout: str, group=None):
        gn = cfg.graph_norm.strip()
        if gn not in NORMS:
            raise ValueError(f"sharded path: unsupported graph_norm "
                             f"{cfg.graph_norm!r}")
        for key in ("pre_norm", "flat_norm"):
            if getattr(cfg, key).strip() != "_None":
                raise ValueError(f"sharded path: {key} must be '_None'")
        self.group = group
        self.block, self.readout = block.strip(), readout.strip()
        self.graph_norm = gn
        self.steps = cfg.message_steps
        self.residual = bool(cfg.graph_res)
        self.use_gru = self.block not in NO_GRU_CONVS
        self.act_pre, self.act_g = _act(cfg.pre_act), _act(cfg.graph_act)
        self.rrelu = activation_key(cfg.graph_act) == "RReLU"
        self.conv = tower.conv.conv
        self.norm_mod = tower.conv.norm
        # the parameters shard-local work reads; the flat layer and
        # Set2Set's LSTM work on replicated vectors
        self.local_names = [n for n, _ in tower.named_parameters()
                            if not n.startswith(("flat.", "readout.lstm_"))]
        self.params = dict(tower.named_parameters())
        # the JAX package's A/B switch, read where it reads it
        self.overlap = os.environ.get("GLAM_SHARDED_OVERLAP", "1") != "0"

    # -- collectives -------------------------------------------------
    def halo_start(self, z, s: Shard):
        """Issue the exchange of the rows of ``z`` [R, ...] that other
        shards read; returns ``finish()`` -> the [T, ...] table, ``z``
        then the rows they send.  Without the overlap the exchange is
        waited for here."""
        segs = s.send_segments()
        if s.ring is None:
            D = s.send_idx.shape[0]
            sends, ks = [segs[0].gather(z).view(D, -1, *z.shape[1:])], None
        else:
            ks = [k for k, idx in enumerate(s.ring, start=1) if idx.numel()]
            sends = [segs[k - 1].gather(z) for k in ks]
        started = dd.exchange_start(sends, ks, self.group,
                                    blocking=not self.overlap) \
            if sends else None

        def finish():
            recv = dd.exchange_finish(started) if started else []
            return torch.cat([z] + [r.reshape(-1, *z.shape[1:])
                                    for r in recv])
        return finish

    def halo(self, z, s: Shard):
        """[T, ...]: ``z`` [R, ...] and the rows other shards send."""
        return self.halo_start(z, s)()

    # -- norms -------------------------------------------------------
    def norm(self, lp, x, s: Shard, w):
        gn = self.graph_norm
        if gn == "_None":
            return x
        B, Nl, C = s.n_pairs, s.n_local, x.shape[-1]
        xv = x.view(B, Nl, C)
        m = s.node_mask.view(B, Nl, 1).to(x.dtype)
        cnt = s.graph_nodes.to(x.dtype)                        # [B]
        if gn == "_GraphSizeNorm":
            return (xv * torch.rsqrt(cnt.clamp(min=1.0))[:, None, None]
                    ).view(-1, C)
        if gn == "_PairNorm":
            cnt = cnt.clamp(min=1.0)
            mean = dd.reduce_to_local((xv * m).sum(1), self.group) \
                / cnt[:, None]
            xc = (xv - mean[:, None]) * m
            ms = dd.reduce_to_local((xc * xc).sum((1, 2)), self.group) / cnt
            return (xc / torch.sqrt(1e-5 + ms)[:, None, None]).view(-1, C)
        if gn == "_LayerNorm":
            denom = (cnt * C).clamp(min=1.0)
            mean = dd.reduce_to_local((xv * m).sum((1, 2)), self.group) \
                / denom
            xc = (xv - mean[:, None, None]) * m
            var = dd.reduce_to_local((xc * xc).sum((1, 2)), self.group) \
                / denom
            out = (xc / torch.sqrt(var + 1e-5)[:, None, None]).view(-1, C)
            return out * lp["conv.norm.scale"] + lp["conv.norm.bias"]
        bn = self.norm_mod                                   # _BatchNorm
        if bn.training:
            mw = m if w is None else m * w.view(B, 1, 1).to(x.dtype)
            cnt = (cnt if w is None else cnt * w.to(x.dtype)).sum() \
                .clamp(min=1.0)
            mean = dd.reduce_to_local((xv * mw).sum((0, 1)), self.group) \
                / cnt
            xc = (xv - mean) * mw
            var = dd.reduce_to_local((xc * xc).sum((0, 1)), self.group) \
                / cnt
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                mom = bn.momentum
                bn.mean.copy_((1 - mom) * bn.mean + mom * mean)
                bn.var.copy_((1 - mom) * bn.var + mom * unbiased)
        else:
            mean, var = bn.mean, bn.var
        inv = torch.rsqrt(var + bn.eps)
        return (x - mean) * inv * lp["conv.norm.scale"] + lp["conv.norm.bias"]

    # -- message steps -----------------------------------------------
    def _finish(self, lp, y, x_local, h_prev, s, slope):
        """MessageBlock's tail: [CELU -> GRU] -> residual -> activation,
        masked to the real rows."""
        if self.use_gru:
            y = gru_cell(celu(y), h_prev, lp["conv.gru.weight_ih"],
                         lp["conv.gru.weight_hh"], lp["conv.gru.bias_ih"],
                         lp["conv.gru.bias_hh"])
            h_prev = y
        if self.residual:
            y = y + x_local
        y = torch.where(y >= 0, y, y * slope) if slope is not None \
            else self.act_g(y)
        return y * s.node_mask[:, None].to(y.dtype), h_prev

    # Each conv issues its halo first, computes what does not read the
    # table, runs ``between`` (the previous step's deferred statistics)
    # and then waits for the table.
    def _triplet(self, lp, x_in, s, between):
        conv = self.conv
        C, H, R = conv.channels, conv.heads, x_in.shape[0]
        xp = x_in @ lp["conv.conv.weight_node"]                # [R, H*C]
        w_i, w_e, w_j = lp["conv.conv.weight_triplet_att"].split(C, dim=1)
        finish = self.halo_start(xp, s)
        a_i = torch.einsum("nhc,hc->nh", xp.view(R, H, C), w_i)
        a_i = torch.cat([a_i, a_i.new_zeros((s.table_rows - R, H))])
        wemat = conv.head_onehot * w_e.reshape(-1, 1)
        between()
        table = finish()                                       # [T, H*C]
        a_j = torch.einsum("nhc,hc->nh", table.view(-1, H, C), w_j)
        aggr = triplet_attention(
            table.contiguous(), a_i.contiguous(), a_j.contiguous(), s.edges,
            lp["conv.conv.weight_edge"].contiguous(), wemat, s.csr_rowptr,
            s.csr_snd, s.csr_eid, H, C, conv.negative_slope)[:R]
        return aggr @ lp["conv.conv.weight_scale"] + lp["conv.conv.bias"]

    def _light(self, lp, x_in, s, between):
        conv = self.conv
        C, Fe, R = conv.channels, conv.edge_channels, x_in.shape[0]
        xp = x_in @ lp["conv.conv.weight_node"]                # [R, C]
        w_i, w_e, w_j = lp["conv.conv.weight_triplet_att"].split([C, Fe, C])
        finish = self.halo_start(xp, s)
        snd, rcv = s.sender_segments, s.receiver_segments
        local = rcv.gather(xp @ w_i) + s.edges @ w_e
        between()
        table = finish()
        logits = local + snd.gather(table @ w_j)
        logits = torch.where(logits >= 0, logits,
                             conv.negative_slope * logits)
        aggr = segment_softmax_spmm(logits[:, None].contiguous(),
                                    snd.gather(table), s.pad_rowptr,
                                    s.csr_eid)[:R]
        return aggr + lp["conv.conv.bias"]

    def _gat(self, lp, x_in, s, between):
        conv = self.conv
        xp = F.linear(x_in, lp["conv.conv.weight"])            # [R, C]
        att_src, att_dst = lp["conv.conv.att_src"][0], \
            lp["conv.conv.att_dst"][0]
        finish = self.halo_start(xp, s)
        a_src, a_dst = xp @ att_src, xp @ att_dst
        loops = a_src + a_dst                                  # [R]
        between()
        table = finish()
        slope = conv.negative_slope
        snd = s.sender_segments
        logits = torch.cat([snd.gather(table @ att_src)
                            + s.receiver_segments.gather(a_dst),
                            loops])                            # [E + R]
        logits = torch.where(logits >= 0, logits, slope * logits)
        values = torch.cat([snd.gather(table), xp])
        out = segment_softmax_spmm(logits[:, None].contiguous(), values,
                                   s.loop_rowptr, s.loop_idx)[:xp.shape[0]]
        return out + lp["conv.conv.bias"]

    def _nnconv(self, lp, x_in, s, between):
        conv = self.conv
        ci, co = conv.in_channels, conv.out_channels
        finish = self.halo_start(x_in, s)
        h1 = F.relu(F.linear(s.edges, lp["conv.conv.edge_mlp_0.weight"],
                             lp["conv.conv.edge_mlp_0.bias"]))
        wmat = F.linear(h1, lp["conv.conv.edge_mlp_1.weight"],
                        lp["conv.conv.edge_mlp_1.bias"]).view(-1, ci, co)
        root = x_in @ lp["conv.conv.root"]
        between()
        table = finish()
        msg = torch.bmm(s.sender_segments.gather(table)[:, None, :],
                        wmat)[:, 0]
        em = s.edge_mask[:, None].to(msg.dtype)
        rcv = s.receiver_segments
        tot = rcv.sum(msg * em)
        cnt = rcv.sum(em[:, 0]).clamp(min=1.0)
        return tot / cnt[:, None] + root + lp["conv.conv.bias"]

    def _gcn(self, lp, x_in, s, between):
        xp = F.linear(x_in, lp["conv.conv.weight"])
        finish = self.halo_start(xp, s)
        loops = s.self_norm[:, None] * xp
        w = torch.where(s.edge_mask, s.edge_norm, 0.0)
        between()
        table = finish()
        out = s.receiver_segments.sum(
            w[:, None] * s.sender_segments.gather(table))
        return out + loops + lp["conv.conv.bias"]

    _CONVS = {"_TripletMessage": _triplet, "_TripletMessageLight": _light,
              "_GATConv": _gat, "_NNConv": _nnconv, "_GCNConv": _gcn}

    # -- readouts ----------------------------------------------------
    def pool(self, lp, x, s: Shard):
        B, Nl, C = s.n_pairs, s.n_local, x.shape[-1]
        mask = s.node_mask.view(B, Nl)
        xv = x.view(B, Nl, C)
        g = self.group
        if self.readout == "GlobalLAPool":
            gate = F.linear(x, lp["readout.gate_nn.weight"],
                            lp["readout.gate_nn.bias"])[:, 0].view(B, Nl)
            gate = torch.where(mask, gate, -torch.inf)
            gmax = dd.all_reduce_max(gate.detach().amax(1), g)
            ex = torch.where(mask, torch.exp(gate - gmax[:, None]), 0.0)
            val = F.linear(x, lp["readout.nn.weight"],
                           lp["readout.nn.bias"]).view(B, Nl, -1)
            both = dd.reduce_to_replicated(torch.cat(
                [(ex[..., None] * val).sum(1), ex.sum(1, keepdim=True)],
                -1), g)                       # one all-reduce for both
            return both[:, :-1] / (both[:, -1:] + 1e-16)
        if self.readout == "GlobalPool5":
            m = mask[..., None].to(x.dtype)
            total = dd.reduce_to_replicated((xv * m).sum(1), g)
            mean = total / s.graph_nodes.to(x.dtype).clamp(min=1.0)[:, None]
            k = 3
            keys = torch.where(mask, xv[..., -1], -torch.inf)
            # value descending, then the lower (global) index first: a
            # stable sort; the ranks' candidates gather in rank order
            idx = torch.sort(keys.detach(), dim=1, descending=True,
                             stable=True).indices[:, :k]        # [B, k]
            kv = torch.gather(keys.detach(), 1, idx)
            rows = torch.gather(xv, 1, idx[..., None].expand(-1, -1, C))
            # the keys ride with the rows: one all_gather [D, B, k, C+1]
            every = dd.all_gather_replicated(
                torch.cat([rows, kv[..., None]], -1), g).transpose(0, 1)
            rows_all = every[..., :C].reshape(B, -1, C)
            kv_all = every[..., C].detach().reshape(B, -1)
            gi = torch.sort(kv_all, dim=1, descending=True,
                            stable=True).indices[:, :k]
            top = torch.gather(rows_all, 1, gi[..., None].expand(-1, -1, C))
            ok = torch.isfinite(torch.gather(kv_all, 1, gi))
            top = torch.where(ok[..., None], top, 0.0)
            return torch.cat([mean, total, top.reshape(B, -1)], -1)
        # Set2Set (3 steps): the LSTM state is replicated, the attention
        # over the shard's rows
        p = self.params
        q_star = x.new_zeros((B, 2 * C))
        h = x.new_zeros((B, C))
        c = x.new_zeros((B, C))
        for _ in range(3):
            q, c = lstm_cell(q_star, h, c, p["readout.lstm_w_ih"],
                             p["readout.lstm_w_hh"], p["readout.lstm_b_ih"],
                             p["readout.lstm_b_hh"])
            h = q
            (q_l,) = dd.enter_local(q, group=g)
            e = torch.where(mask, (xv * q_l[:, None, :]).sum(-1), -torch.inf)
            emax = dd.all_reduce_max(e.detach().amax(1), g)
            ex = torch.where(mask, torch.exp(e - emax[:, None]), 0.0)
            both = dd.reduce_to_replicated(torch.cat(
                [(ex[..., None] * xv).sum(1), ex.sum(1, keepdim=True)], -1),
                g)
            r = both[:, :-1] / (both[:, -1:] + 1e-16)
            q_star = torch.cat([q, r], -1)
        return q_star

    def fusion_stats(self, xm, mvalid, x, s: Shard):
        """[B, 2]: the [max, mean] of each pair's dot products between
        the molecule's node states xm [B, M, C] (already local) and the
        protein's; the max's value and gradient come from the shard(s)
        that hold it, divided by their count."""
        return self.fusion_reduce(self.fusion_local(xm, mvalid, x, s),
                                  mvalid, s)

    def fusion_local(self, xm, mvalid, x, s: Shard):
        """:meth:`fusion_stats`' shard-local part, no collective: each
        pair's largest valid product on this shard and their sum."""
        B, Nl, C = s.n_pairs, s.n_local, x.shape[-1]
        sc = torch.bmm(xm, x.view(B, Nl, C).transpose(1, 2))   # [B, M, Nl]
        valid = mvalid[:, :, None] & s.node_mask.view(B, 1, Nl)
        return (torch.where(valid, sc, -torch.inf).amax((1, 2)),   # [B]
                torch.where(valid, sc, 0.0).sum((1, 2)))

    def fusion_reduce(self, local, mvalid, s: Shard):
        """:meth:`fusion_stats`' collectives and division, on
        :meth:`fusion_local`'s result."""
        smax, tot = local
        g = self.group
        owner = smax.detach() == dd.all_reduce_max(smax, g)
        # the owners' max, the sum and the owner count: one all-reduce
        mx, tot, n_own = dd.reduce_to_replicated(torch.stack(
            [torch.where(owner, smax, 0.0), tot, owner.to(smax.dtype)]), g)
        cnt = mvalid.sum(1).to(smax.dtype) * s.graph_nodes.to(smax.dtype)
        return torch.stack([mx / n_own.clamp(min=1.0),
                            tot / cnt.clamp(min=1.0)], -1)

    def __call__(self, s: Shard, noise=None, fusion=None, bn_weight=None):
        lp = dict(zip(self.local_names, dd.enter_local(
            *[self.params[n] for n in self.local_names], group=self.group)))
        x = F.linear(s.nodes, lp["lin0.linear.weight"],
                     lp["lin0.linear.bias"])
        x = self.act_pre(x) * s.node_mask[:, None].to(x.dtype)
        h = x
        drop, slopes = noise if noise is not None else (None, None)
        step_conv = self._CONVS[self.block]
        if fusion is not None:
            (xm_all,) = dd.enter_local(fusion[0], group=self.group)
            mvalid = fusion[1]
        stats = []
        # the deferral (glam_tpu/parallel/sharded_model.py:664-689): step
        # t's statistics wait for step t + 1's halo; their local part runs
        # while it is in flight, their collectives once it has arrived
        pending, local = None, []

        def between():
            if pending is not None:
                local.append(self.fusion_local(xm_all[pending[0]], mvalid,
                                               pending[1], s))

        for step in range(self.steps):
            x_in = self.norm(lp, x, s, bn_weight)
            if drop is not None:
                x_in = x_in * drop[step]
            slope = slopes[step] if (slopes is not None and self.rrelu) \
                else None
            y = step_conv(self, lp, x_in, s, between)
            if local:
                stats.append(self.fusion_reduce(local.pop(), mvalid, s))
            x, h = self._finish(lp, y, x, h, s, slope)
            if fusion is not None:
                # the statistics read the step's output through an alias
                # made here either way, so that its gradient's terms add
                # in one order with the deferral and without it
                xf = x.view_as(x)
                if self.overlap:
                    pending = (step, xf)
                else:
                    stats.append(self.fusion_stats(xm_all[step], mvalid, xf,
                                                   s))
        if pending is not None:
            stats.append(self.fusion_stats(xm_all[pending[0]], mvalid,
                                           pending[1], s))
        pooled = self.pool(lp, x, s)
        return pooled, (torch.stack(stats, 1) if fusion is not None
                        else None)


# ------------------------------------------------- forwards and steps
def make_sharded_forward(model, group=None):
    """``forward(shard, noise=None)`` -> [B, out_dim]: a dense
    ``Architecture``'s prediction for each of the shard's B graphs,
    its tower sharded (the norms' mode follows ``model.train()`` /
    ``eval()``); the flat layer and ``lin_out1`` act deterministically,
    as the JAX package's sharded head."""
    cfg = model.cfg
    if cfg.end_norm.strip() != "_None":
        raise ValueError("sharded path: end_norm must be _None")
    tower = ShardedTower(model.mol, cfg, cfg.mol_block, cfg.mol_readout,
                         group)
    act_flat = _act(cfg.flat_act)

    def forward(shard: Shard, noise=None, bn_weight=None):
        pooled, _ = tower(shard, noise=noise, bn_weight=bn_weight)
        out = act_flat(model.mol.flat.linear(pooled))
        return model.lin_out1.linear(out)

    return forward


def mol_states(xs: Sequence[torch.Tensor], g: GraphBatch, n_pairs: int,
               max_nodes: int):
    """The molecule tower's per-step node states as [S, B, M, C] per
    graph, and the mask of real nodes [B, M]."""
    dense = torch.stack([scatter_nodes_to_dense(
        x, g.node_graph, g.node_pos, g.num_graphs, max_nodes)[:n_pairs]
        for x in xs])
    pos = torch.arange(max_nodes, device=g.device)
    return dense, pos[None, :] < g.n_node[:n_pairs, None]


def make_sharded_pair_forward(model, group=None):
    """``forward(mol_batch, shard, generator=None, noise=None,
    bn_weight=None)`` -> logits [B, out_dim] of a dense
    ``PairArchitecture(hetero=True)``: the molecule tower (``mol1``) runs
    whole on every rank over ``mol_batch`` (B graphs: graph b is pair b's
    molecule; noise from ``generator`` in ``train()`` mode), the protein
    tower (``mol2``) sharded over ``shard``'s B graphs, the per-step
    fusion statistics reduced across the ranks, then the head
    (``lin_out0``, ``lin_out1``; end_norm must be '_None', its dropout
    and the protein tower's flat layer act deterministically, as the JAX
    package's sharded head)."""
    cfg = model.cfg
    if cfg.end_norm.strip() != "_None":
        raise ValueError("sharded pair path: end_norm must be _None")
    tower = ShardedTower(model.mol2, cfg, cfg.pro_block, cfg.pro_readout,
                         group)
    act_flat, act_end = _act(cfg.flat_act), _act(cfg.end_act)

    def forward(mol_batch: GraphBatch, shard: Shard, generator=None,
                noise=None, bn_weight=None):
        B = shard.n_pairs
        out1, xs1 = model.mol1(mol_batch, return_nodes=True,
                               generator=generator)
        fusion = mol_states(xs1, mol_batch, B, cfg.max_nodes)
        pooled, stats = tower(shard, noise=noise, fusion=fusion,
                              bn_weight=bn_weight)
        out2 = act_flat(model.mol2.flat.linear(pooled))
        feats = torch.cat([out1[:B], out2, stats.reshape(B, -1)], -1)
        z = act_end(model.lin_out0.linear(feats))
        return model.lin_out1.linear(z)

    return forward


def sync_grads(model: torch.nn.Module, group=None) -> None:
    """Every rank takes rank 0's gradients (one broadcast of them all):
    each rank's backward already holds the whole gradient, its sums in a
    fixed order, and the broadcast keeps the replicas equal whatever the
    ranks' devices compute.  A
    parameter without a gradient keeps none (every rank runs the same
    graph, so they agree on which; a captured step fixes the set at its
    capture).  Each gradient becomes a view of the one broadcast buffer,
    so a replay allocates nothing outside its graph's pool."""
    params = [p for p in model.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dd.broadcast_(flat, 0, group)
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p)
        at += n


def make_sharded_train_step(model, lr: float = 1e-3, group=None):
    """``step(shard, y [B, out])`` -> loss: one SGD step of mean squared
    error on a dense ``Architecture``, its tower sharded; every rank ends
    with the same parameters.  BatchNorm's running statistics move as in
    the dense model's training-mode forward."""
    fwd = make_sharded_forward(model, group)

    def step(shard: Shard, y: torch.Tensor, noise=None):
        loss = ((fwd(shard, noise) - y) ** 2).mean()
        model.zero_grad(set_to_none=True)
        loss.backward()
        sync_grads(model, group)
        with torch.no_grad():
            for p in model.parameters():
                p -= lr * p.grad
        return loss.detach()

    return step


def make_sharded_pair_train_step(model, lr: float = 1e-3, group=None):
    """``step(mol_batch, shard, y [B, out])`` -> loss: one SGD step of
    mean squared error on a ``PairArchitecture(hetero=True)`` with its
    protein tower sharded."""
    fwd = make_sharded_pair_forward(model, group)

    def step(mol_batch, shard, y, generator=None, noise=None):
        loss = ((fwd(mol_batch, shard, generator, noise) - y) ** 2).mean()
        model.zero_grad(set_to_none=True)
        loss.backward()
        sync_grads(model, group)
        with torch.no_grad():
            for p in model.parameters():
                p -= lr * p.grad
        return loss.detach()

    return step


def local_noise(noises: List[Tuple[torch.Tensor, torch.Tensor]],
                rank: int):
    """This rank's rows of B graphs' :func:`make_stochastic_inputs`,
    packed as :func:`pack_shards` packs the rows: (drop, slope)
    [S, B*Nl, C]."""
    return tuple(torch.cat([n[i][rank] for n in noises], 1)
                 for i in range(2))
