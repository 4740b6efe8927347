"""The graph partition and its halo message steps: the counterpart of the
JAX package's ``parallel/graph_partition.py``.

Host plans (numpy, equal to the JAX package's bit for bit):
  * :func:`partition_graphs` assigns whole graphs to D shards, balancing
    edge counts (LPT greedy), and pads each shard to one shared budget;
  * :func:`split_large_graph` cuts ONE large graph into D contiguous node
    shards; shard d owns the edges whose receiver is local, with global
    sender ids;
  * :func:`build_halo_exchange` (v2: for every ordered shard pair, the
    source-local rows the destination's edges read, and the senders
    remapped into [local ; halo from shard 0 ; ... ; shard D-1]) and
    :func:`build_halo_exchange_ring` (v3: a budget per ring distance).

Message steps, one rank per shard over ``torch.distributed``,
differentiable through the collectives of ``parallel/distributed.py``:
the parameters enter the shard's work through ``enter_local`` and the
table through ``all_gather_local`` (v1) or ``all_to_all_grad`` (v2), so
that, for a loss summed over the shards (``reduce_to_replicated``), each
rank's backward yields the whole gradient of the parameters and its
shard's of the node features:
  * :func:`make_halo_message_step` (v1): all_gather of the projected
    node features, then the aggregation over the gathered table;
  * :func:`make_halo_message_step_v2`: one all_to_all of the
    host-planned ``send_idx`` rows, then the aggregation over the small
    [local ; halo] table.
Both compute a single-head triplet-style attention over the shard's real
edges: logits a_i[rcv] + a_e + a_j[snd], a segment softmax over local
receivers (PyG's 1e-16 epsilon, 0 for an empty row) and sum of
alpha * table[snd].  That segment softmax and sum is kernel C
(``ops/kernels/segment_softmax_spmm.py``) over a receiver CSR of the
shard's real edges, logits [E, 1] and values table[snd]; on CPU tensors
its plain version.  :func:`reference_halo_step` is the single-device
oracle, in plain torch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import GraphArrays, GraphBatch, pad_graphs
from ..ops.kernels.segment_softmax_spmm import segment_softmax_spmm
from .distributed import all_gather_local, all_to_all_grad, enter_local


def partition_graphs(graphs: Sequence[GraphArrays], n_parts: int,
                     num_tasks: int = 1) -> List[GraphBatch]:
    """Partition a list of graphs into ``n_parts`` balanced shards: one
    padded GraphBatch per shard (the JAX package stacks them on a
    leading shard axis), all at one budget, senders and receivers local
    to the shard."""
    # LPT greedy: biggest graphs first onto the lightest shard
    order = np.argsort([-g.senders.shape[0] for g in graphs])
    shards: List[List[GraphArrays]] = [[] for _ in range(n_parts)]
    load = np.zeros(n_parts, np.int64)
    for i in order:
        s = int(np.argmin(load))
        shards[s].append(graphs[i])
        load[s] += graphs[i].senders.shape[0] + 1
    g_budget = max(len(s) for s in shards)
    n_budget = max(sum(g.nodes.shape[0] for g in s) for s in shards) + 8
    e_budget = max(max(sum(g.senders.shape[0] for g in s)
                       for s in shards), 1)
    n_budget = -(-n_budget // 8) * 8
    e_budget = -(-e_budget // 8) * 8
    return [pad_graphs(s, g_budget, n_budget, e_budget, num_tasks)
            for s in shards]


def split_large_graph(nodes: np.ndarray, edges: np.ndarray,
                      senders: np.ndarray, receivers: np.ndarray,
                      n_parts: int, node_budget: int = 0,
                      edge_budget: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Split ONE large graph into node shards and receiver-partitioned
    edge shards with GLOBAL sender ids.

    Returns (node_shards [D, Nl, F], edge_shards [D, El, Fe],
    senders_global [D, El], receivers_local [D, El], edge_mask [D, El]).
    Padding edges point at local node 0 with mask False.  ``node_budget``
    and ``edge_budget`` are floors on the global node count and the
    per-shard edge slots, so graphs of different sizes can share one
    padded shape."""
    N = nodes.shape[0]
    Np = max(N, int(node_budget))
    Nl = -(-Np // n_parts)
    Nl = -(-Nl // 8) * 8
    node_shards = np.zeros((n_parts, Nl, nodes.shape[1]), np.float32)
    for d in range(n_parts):
        chunk = nodes[d * Nl:(d + 1) * Nl]
        node_shards[d, :chunk.shape[0]] = chunk
    owner = receivers // Nl
    counts = np.bincount(owner, minlength=n_parts)
    El = -(-int(counts.max()) // 8) * 8 if len(senders) else 8
    El = max(El, -(-int(edge_budget) // 8) * 8 if edge_budget else 8)
    e_sh = np.zeros((n_parts, El, edges.shape[1]), np.float32)
    s_g = np.zeros((n_parts, El), np.int32)
    r_l = np.zeros((n_parts, El), np.int32)
    mask = np.zeros((n_parts, El), bool)
    fill = np.zeros(n_parts, np.int64)
    for e in range(len(senders)):
        d = int(owner[e])
        k = fill[d]
        e_sh[d, k] = edges[e]
        s_g[d, k] = senders[e]
        r_l[d, k] = receivers[e] - d * Nl
        mask[d, k] = True
        fill[d] += 1
    return node_shards, e_sh, s_g, r_l, mask


def _halo_needs(senders_global, edge_mask, n_local):
    """need[src][dst]: the src-local rows dst's edges read, in first-use
    order; pos[dst]: {global id: its slot in need[src][dst]}."""
    D, El = senders_global.shape
    need: List[List[List[int]]] = [[[] for _ in range(D)]
                                   for _ in range(D)]
    pos: List[dict] = [dict() for _ in range(D)]
    for d in range(D):
        for e in range(El):
            if not edge_mask[d, e]:
                continue
            g = int(senders_global[d, e])
            s = g // n_local
            if s == d:
                continue
            if g not in pos[d]:
                pos[d][g] = len(need[s][d])
                need[s][d].append(g - s * n_local)
    return need, pos


def build_halo_exchange(senders_global: np.ndarray, edge_mask: np.ndarray,
                        n_local: int, halo_budget: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host plan of the boundary-only (v2) halo exchange over the output
    of :func:`split_large_graph` (shard d owns global nodes
    [d*n_local, (d+1)*n_local)).

    Returns send_idx [D, D, H] (send_idx[s, d]: the s-local rows to ship
    to shard d), send_mask [D, D, H] (the real slots), senders_local
    [D, El] (edge senders in shard d's table [local (n_local) ; halo from
    shard 0 (H) ; ... ; shard D-1 (H)]) and H, the halo budget per shard
    pair (the largest boundary rounded up to 8, at least
    ``halo_budget``)."""
    D, El = senders_global.shape
    need, pos = _halo_needs(senders_global, edge_mask, n_local)
    H = max((len(lst) for row in need for lst in row), default=0)
    H = max(-(-H // 8) * 8, 8)
    if halo_budget:  # shared-shape floor (see split_large_graph)
        H = max(H, -(-int(halo_budget) // 8) * 8)
    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    for s in range(D):
        for d in range(D):
            lst = need[s][d]
            send_idx[s, d, :len(lst)] = lst
            send_mask[s, d, :len(lst)] = True
    senders_local = np.zeros((D, El), np.int32)
    for d in range(D):
        for e in range(El):
            if not edge_mask[d, e]:
                continue
            g = int(senders_global[d, e])
            s = g // n_local
            if s == d:
                senders_local[d, e] = g - d * n_local
            else:
                senders_local[d, e] = n_local + s * H + pos[d][g]
    return send_idx, send_mask, senders_local, H


def build_halo_exchange_ring(senders_global: np.ndarray,
                             edge_mask: np.ndarray, n_local: int,
                             budget_floors: Optional[tuple] = None
                             ) -> Tuple[tuple, tuple, np.ndarray]:
    """Host plan of the ring-compacted (v3) halo exchange: one transfer
    per ring distance k (shard s -> (s + k) % D) with its own budget H_k,
    the largest such boundary rounded up to 8 (0 skips the distance).

    Returns send_idxs (for k = 1..D-1, [D, H_k] int32: send_idxs[k-1][s]
    the s-local rows shipped to shard (s + k) % D), budgets (the H_k) and
    senders_local [D, El] (senders in shard d's table [local (n_local) ;
    distance-1 halo (H_1, from shard (d-1) % D) ; distance-2 ; ...])."""
    D, El = senders_global.shape
    need, pos = _halo_needs(senders_global, edge_mask, n_local)
    budgets = []
    for k in range(1, D):
        h = max(len(need[s][(s + k) % D]) for s in range(D))
        b = -(-h // 8) * 8 if h else 0
        if budget_floors is not None:  # shared-shape floor per distance
            b = max(b, int(budget_floors[k - 1]))
        budgets.append(b)
    send_idxs = []
    for k in range(1, D):
        idx = np.zeros((D, budgets[k - 1]), np.int32)
        for s in range(D):
            lst = need[s][(s + k) % D]
            idx[s, :len(lst)] = lst
        send_idxs.append(idx)
    # table offset of the distance-k section
    offs = np.concatenate([[0], np.cumsum(budgets)]) + n_local
    senders_local = np.zeros((D, El), np.int32)
    for d in range(D):
        for e in range(El):
            if not edge_mask[d, e]:
                continue
            g = int(senders_global[d, e])
            s = g // n_local
            if s == d:
                senders_local[d, e] = g - d * n_local
            else:
                k = (d - s) % D
                senders_local[d, e] = offs[k - 1] + pos[d][g]
    return tuple(send_idxs), tuple(budgets), senders_local


def init_halo_params(generator: torch.Generator, channels: int,
                     edge_channels: int, device="cpu"):
    """{'weight_node' [C, C], 'weight_att' [3C], 'weight_edge' [Fe]},
    uniform in +-sqrt(6 / C), drawn from ``generator``."""
    bound = (6.0 / channels) ** 0.5

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * 2 * bound - bound).to(device)

    return {"weight_node": uniform(channels, channels),
            "weight_att": uniform(3 * channels),
            "weight_edge": uniform(edge_channels)}


def reference_halo_step(params, nodes, edges, senders, receivers,
                        edge_mask=None):
    """Single-device oracle of the halo steps, in plain torch: the whole
    graph's [N, C] output."""
    C = nodes.shape[-1]
    xp = nodes @ params["weight_node"]
    w = params["weight_att"]
    a_i = xp @ w[:C]
    a_j = xp @ w[2 * C:]
    a_e = edges @ params["weight_edge"]
    senders, receivers = senders.long(), receivers.long()
    logits = a_i[receivers] + a_e + a_j[senders]
    if edge_mask is not None:
        logits = torch.where(edge_mask, logits, -torch.inf)
    N = nodes.shape[0]
    seg_max = logits.new_full((N,), -torch.inf).scatter_reduce(
        0, receivers, logits, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max[receivers])
    if edge_mask is not None:
        ex = torch.where(edge_mask, ex, 0.0)
    denom = torch.zeros(N, dtype=ex.dtype, device=ex.device).index_add_(
        0, receivers, ex)
    alpha = ex / (denom[receivers] + 1e-16)
    return torch.zeros_like(xp).index_add_(0, receivers,
                                           alpha[:, None] * xp[senders])


def _aggregate(params, xp_l, table, edges_l, snd, rcv_l, emask):
    """The shard's output [Nl, C]: the attention over its real edges
    (senders index ``table``), its segment softmax and sum by kernel C
    over their receiver CSR."""
    C, Nl = xp_l.shape[1], xp_l.shape[0]
    w = params["weight_att"]
    real = emask.nonzero().flatten()
    r, s = rcv_l.long()[real], snd.long()[real]
    logits = (xp_l @ w[:C])[r] + edges_l[real] @ params["weight_edge"] \
        + (table @ w[2 * C:])[s]
    order = torch.sort(r, stable=True).indices
    rowptr = torch.zeros(Nl + 1, dtype=torch.int32, device=xp_l.device)
    rowptr[1:] = torch.cumsum(torch.bincount(r, minlength=Nl), 0)
    return segment_softmax_spmm(
        logits[:, None].contiguous(), table[s].contiguous(), rowptr,
        order.to(torch.int32))


def _local(params, group):
    """The step's parameters as they enter the shard's work (f)."""
    names = sorted(params)
    return dict(zip(names, enter_local(*[params[n] for n in names],
                                       group=group)))


def make_halo_message_step(group=None):
    """v1: ``step(params, nodes_l [Nl, C], edges_l [El, Fe], snd_g [El]
    (global ids), rcv_l [El] (local), emask [El]) -> [Nl, C]`` on this
    rank's shard (rank d owns global nodes [d*Nl, (d+1)*Nl)): the
    projected features of every shard all-gathered into the global table,
    then the aggregation against it."""
    def step(params, nodes_l, edges_l, snd_g, rcv_l, emask):
        params = _local(params, group)
        xp_l = nodes_l @ params["weight_node"]          # local projection
        table = all_gather_local(xp_l, group).reshape(-1, xp_l.shape[1])
        return _aggregate(params, xp_l, table, edges_l, snd_g, rcv_l,
                          emask)

    return step


def make_halo_message_step_v2(group=None):
    """v2: ``step(params, nodes_l, edges_l, snd_l [El] (into the
    [local ; halo] table of :func:`build_halo_exchange`), rcv_l, emask,
    send_idx [D, H] (this shard's row of the plan)) -> [Nl, C]``: the
    rows ``send_idx[d]`` of the local projection go to shard d in one
    all_to_all, and the aggregation runs against [xp_l ; halo]."""
    def step(params, nodes_l, edges_l, snd_l, rcv_l, emask, send_idx):
        params = _local(params, group)
        xp_l = nodes_l @ params["weight_node"]
        halo = all_to_all_grad(xp_l[send_idx.long()], group)  # [D, H, C]
        table = torch.cat([xp_l, halo.reshape(-1, xp_l.shape[1])])
        return _aggregate(params, xp_l, table, edges_l, snd_l, rcv_l,
                          emask)

    return step


def halo_bytes(n_local: int, halo: int, channels: int, ranks: int):
    """Bytes of float32 features a rank receives per step: (v1, v2)."""
    return ((ranks - 1) * n_local * channels * 4,
            (ranks - 1) * halo * channels * 4)
