"""Host-side batch assembly: graphs -> fixed-shape GraphBatch stream.

The single-device ``GraphLoader`` of the JAX package's
``data/batching.py``: one static (num_nodes, num_edges) budget per
(dataset, batch_size), rounded up to a multiple of 8, and the final
partial batch padded with empty graph slots; and ``prefetch``, which
assembles batches on a background thread.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional, Sequence

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
        if node_budget is None:
            # worst case: the batch_size largest graphs (any shuffle order)
            ns = sorted((g.nodes.shape[0] for g in self.graphs),
                        reverse=True)
            node_budget = _round_up(sum(ns[:batch_size]) + 1)
        if edge_budget is None:
            es = sorted((g.senders.shape[0] for g in self.graphs),
                        reverse=True)
            edge_budget = _round_up(max(sum(es[:batch_size]), 1))
        self.node_budget = node_budget
        self.edge_budget = edge_budget

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
