"""Host-side batch assembly: graphs -> fixed-shape GraphBatch stream.

The single-device ``GraphLoader`` and ``PairGraphLoader`` of the JAX
package's ``data/batching.py``: one static (num_nodes, num_edges) budget
per (dataset, batch_size) and per tower, the sum over the batch_size
largest graphs rounded up to a multiple of 8, and the final partial batch
padded with empty graph slots; and ``prefetch``, which assembles batches
on a background thread.
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


class GraphLoader:
    """Iterates fixed-shape GraphBatches (on the CPU) over a list of
    featurized graphs.

    shuffle=True reshuffles each epoch with a per-epoch seed (epoch is
    tracked internally; call ``set_epoch`` to override)."""

    def __init__(self, graphs: Sequence[GraphArrays], batch_size: int,
                 num_tasks: int, shuffle: bool = False, seed: int = 0,
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.num_tasks = num_tasks
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        worst = worst_case_budgets(self.graphs, batch_size)
        self.node_budget = worst[0] if node_budget is None else node_budget
        self.edge_budget = worst[1] if edge_budget is None else edge_budget

    def __len__(self) -> int:
        return math.ceil(len(self.graphs) / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i:i + self.batch_size]]
            yield pad_graphs(chunk, self.batch_size, self.node_budget,
                             self.edge_budget, self.num_tasks)


class PairGraphLoader:
    """Iterates (g1, g2) pairs of fixed-shape GraphBatches (on the CPU) in
    locked step over aligned pair samples; the labels ride on g1's ``y``.

    Each tower has its own (node, edge) budget (see
    :func:`worst_case_budgets`); ``budget1`` / ``budget2`` are floors
    under them, which serving pins across calls.  shuffle=True reshuffles
    each epoch as ``GraphLoader`` does."""

    def __init__(self, pairs: Sequence[Tuple[GraphArrays, GraphArrays]],
                 batch_size: int, num_tasks: int, shuffle: bool = False,
                 seed: int = 0, budget1: Optional[Tuple[int, int]] = None,
                 budget2: Optional[Tuple[int, int]] = None):
        self.pairs = list(pairs)
        self.batch_size = batch_size
        self.num_tasks = num_tasks
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        def floor(computed, given):
            if given is None:
                return computed
            return (max(computed[0], int(given[0])),
                    max(computed[1], int(given[1])))

        self.budget1 = floor(worst_case_budgets(
            [p[0] for p in self.pairs], batch_size), budget1)
        self.budget2 = floor(worst_case_budgets(
            [p[1] for p in self.pairs], batch_size), budget2)

    def __len__(self) -> int:
        return math.ceil(len(self.pairs) / self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[GraphBatch, GraphBatch]]:
        order = np.arange(len(self.pairs))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        for i in range(0, len(order), self.batch_size):
            chunk = [self.pairs[j] for j in order[i:i + self.batch_size]]
            yield tuple(pad_graphs([p[side] for p in chunk],
                                   self.batch_size, *budget, self.num_tasks)
                        for side, budget in ((0, self.budget1),
                                             (1, self.budget2)))
