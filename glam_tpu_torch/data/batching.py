"""Host-side batch assembly: graphs -> fixed-shape GraphBatch stream.

The ``GraphLoader`` and ``PairGraphLoader`` of the JAX package's
``data/batching.py``: one static (num_nodes, num_edges) budget per
(dataset, batch_size) and per tower, the sum over the batch_size largest
graphs rounded up to a multiple of 8, and the final partial batch padded
with empty graph slots; and ``prefetch``, which assembles batches on a
background thread.

Data parallelism (``n_devices`` D > 1, ``rank`` k): each global batch of
``batch_size`` is cut into D contiguous sub-batches of batch_size / D,
and the loader of rank k yields sub-batch k, ``glob[k*bs:(k+1)*bs]``,
padded to the budgets of the per-rank batch size; a trailing sub-batch
may be all padding.  The ranks' sub-batches together are the JAX
loader's device-stacked batch.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .graph import GraphArrays, GraphBatch, pad_graphs


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue, so
    that host-side batch assembly overlaps the device's work.  An
    exception in the thread is raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as exc:  # surface errors in the consumer
            q.put((sentinel, exc))
            return
        q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, tuple) and len(item) == 2 and \
                item[0] is sentinel:
            raise item[1]
        yield item


def _round_up(x: int, m: int = 8) -> int:
    return int(math.ceil(max(x, 1) / m) * m)


def max_graph_nodes(graphs: Sequence[GraphArrays]) -> int:
    return max((g.nodes.shape[0] for g in graphs), default=1)


def worst_case_budgets(graphs: Sequence[GraphArrays],
                       batch_size: int) -> Tuple[int, int]:
    """(node, edge) budgets that fit any batch of ``batch_size`` of
    ``graphs`` in any order: the batch_size largest graphs' counts (one
    padding node more), rounded up to a multiple of 8."""
    ns = sorted((g.nodes.shape[0] for g in graphs), reverse=True)
    es = sorted((g.senders.shape[0] for g in graphs), reverse=True)
    return (_round_up(sum(ns[:batch_size]) + 1),
            _round_up(max(sum(es[:batch_size]), 1)))


def _split(batch_size: int, n_devices: int, rank: int):
    """(global batch, per-rank batch size, D, rank), checked."""
    D = max(int(n_devices), 1)
    if batch_size % D:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"n_devices {D}")
    if not 0 <= rank < D:
        raise ValueError(f"rank {rank} outside [0, {D})")
    return batch_size, batch_size // D, D, int(rank)


def _dims(graphs: Sequence[GraphArrays]) -> Tuple[int, int]:
    """(node features, edge features) of ``graphs``, for empty batches."""
    if not graphs:
        return 0, 0
    e = graphs[0].edges
    return (int(graphs[0].nodes.shape[1]),
            int(e.shape[1]) if e.ndim == 2 else 0)


class GraphLoader:
    """Iterates fixed-shape GraphBatches (on the CPU) over a list of
    featurized graphs; with ``n_devices`` > 1, rank ``rank``'s
    sub-batches (see the module docstring).

    shuffle=True reshuffles each epoch with a per-epoch seed (epoch is
    tracked internally; call ``set_epoch`` to override)."""

    def __init__(self, graphs: Sequence[GraphArrays], batch_size: int,
                 num_tasks: int, shuffle: bool = False, seed: int = 0,
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None, n_devices: int = 1,
                 rank: int = 0):
        self.graphs = list(graphs)
        self.global_batch, self.batch_size, self.n_devices, self.rank = \
            _split(batch_size, n_devices, rank)
        self.num_tasks = num_tasks
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.dims = _dims(self.graphs)
        worst = worst_case_budgets(self.graphs, self.batch_size)
        self.node_budget = worst[0] if node_budget is None else node_budget
        self.edge_budget = worst[1] if edge_budget is None else edge_budget

    def __len__(self) -> int:
        return math.ceil(len(self.graphs) / self.global_batch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        lo = self.rank * self.batch_size
        for i in range(0, len(order), self.global_batch):
            glob = order[i:i + self.global_batch]
            chunk = [self.graphs[j] for j in glob[lo:lo + self.batch_size]]
            yield pad_graphs(chunk, self.batch_size, self.node_budget,
                             self.edge_budget, self.num_tasks, *self.dims)


class PairGraphLoader:
    """Iterates (g1, g2) pairs of fixed-shape GraphBatches (on the CPU) in
    locked step over aligned pair samples; the labels ride on g1's ``y``.

    Each tower has its own (node, edge) budget (see
    :func:`worst_case_budgets`); ``budget1`` / ``budget2`` are floors
    under them, which serving pins across calls.  shuffle=True reshuffles
    each epoch as ``GraphLoader`` does, and ``n_devices``/``rank`` cut
    each global batch as it does."""

    def __init__(self, pairs: Sequence[Tuple[GraphArrays, GraphArrays]],
                 batch_size: int, num_tasks: int, shuffle: bool = False,
                 seed: int = 0, budget1: Optional[Tuple[int, int]] = None,
                 budget2: Optional[Tuple[int, int]] = None,
                 n_devices: int = 1, rank: int = 0):
        self.pairs = list(pairs)
        self.global_batch, self.batch_size, self.n_devices, self.rank = \
            _split(batch_size, n_devices, rank)
        self.num_tasks = num_tasks
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        def floor(computed, given):
            if given is None:
                return computed
            return (max(computed[0], int(given[0])),
                    max(computed[1], int(given[1])))

        sides = [[p[k] for p in self.pairs] for k in (0, 1)]
        self.budget1, self.budget2 = (
            floor(worst_case_budgets(gs, self.batch_size), given)
            for gs, given in zip(sides, (budget1, budget2)))
        self.dims = [_dims(gs) for gs in sides]

    def __len__(self) -> int:
        return math.ceil(len(self.pairs) / self.global_batch)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[GraphBatch, GraphBatch]]:
        order = np.arange(len(self.pairs))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        lo = self.rank * self.batch_size
        for i in range(0, len(order), self.global_batch):
            glob = order[i:i + self.global_batch]
            chunk = [self.pairs[j] for j in glob[lo:lo + self.batch_size]]
            yield tuple(pad_graphs([p[side] for p in chunk],
                                   self.batch_size, *budget, self.num_tasks,
                                   *self.dims[side])
                        for side, budget in ((0, self.budget1),
                                             (1, self.budget2)))
