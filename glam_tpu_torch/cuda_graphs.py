"""CUDA graphs of the port's hot calls: the counterpart of the JAX
package's one compiled executable per batch shape (``jax.jit``'s cache).
What the trainer's captured steps (``train/step_graph.py``) and the
predictors' captured forwards (``serve.py``) share:

  * :func:`signature`: the shapes and dtypes of every tensor of a loader
    item's parts (GraphBatches, or any tree of dataclasses, tuples and
    tensors: the node-sharded trainer's batch, shard, labels and noise).
    A loader's budgets are pinned, so all its batches share one;
  * :class:`Slots`: the static input tensors of one loader item, each
    tensor a view into one device buffer that one non-blocking copy from
    one pinned host buffer fills;
  * :class:`CapturedCalls`: a side stream on which a signature's first
    call runs eagerly (the warm-up, which makes the kernels' ticket
    buffers on that stream, ``ops/kernels/common.py``, the optimizer's
    state and the libraries' handles before anything is captured), the
    capture into a memory pool, and the replay.  A capture runs nothing,
    so the kernel launches its wrappers count while it is captured are
    taken back and added again at every replay
    (``ops.kernels.add_launches``).  A graph that holds nccl
    collectives is captured in "thread_local" mode
    (``capture_error_mode``);
  * :class:`ForwardGraphs`: a forward-only cache, one graph per
    signature, each in a pool of its own, for the predictors: a
    signature's first item runs eagerly on the side stream, its second
    is captured, later ones replay.  Pinned signatures stay; of the
    others only the most recent ``ForwardGraphs.KEEP`` do, and a dropped
    one's graph, pool and slot are freed.

A failure to capture raises; nothing continues eagerly in its place.  A
capture and its replays run under the grad mode the caller sets, which
must be the eager path's.  Every segment sum runs in a fixed order
(``ops/segment.py``), so a replay equals the eager call bitwise.  A
capture first collects Python's garbage and keeps the collector off
until it ends: a dead reference cycle that holds another graph (a
trainer holds its graphs, which hold its steps, which hold the trainer)
must not be freed mid-capture, where destroying a graph is a CUDA call
that invalidates the capture.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .data.graph import GraphBatch
from .ops.kernels import add_launches, launch_counts

_ALIGN = 256     # bytes between the starts of two fields in a slot


def _spec(tree):
    """A hashable description of ``tree``: each tensor's shape and dtype,
    each dataclass's type and fields, each tuple's items, and any other
    leaf (an int, None) as it is."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if dataclasses.is_dataclass(tree):
        return (type(tree).__name__,) + tuple(
            (f.name, _spec(getattr(tree, f.name)))
            for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_spec(x) for x in tree)
    return tree


def _tensors(tree):
    """The tensors of ``tree`` (dataclasses, tuples and lists of them),
    depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)


def _rebuild(tree, tensors):
    """``tree`` with its tensors taken in turn from the iterator
    ``tensors``; every other leaf kept."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, tensors) for x in tree)
    return tree


def signature(parts) -> Tuple:
    """The shapes and dtypes of every tensor of a loader item's parts
    (GraphBatches, or any tree of dataclasses, tuples and tensors), with
    the tree's layout and its other leaves."""
    return _spec(parts)


class Slots:
    """Static device tensors of one loader item: each tensor of its parts
    is a view into one device byte buffer, filled by one non-blocking copy
    from one pinned host buffer, which the host fills tensor by tensor
    once the previous copy out of it has run.  ``parts`` has the item's
    layout (a tuple of GraphBatches, or any tree of dataclasses, tuples
    and tensors, whose other leaves it keeps).  On the CPU the host
    buffer is not pinned and the copy is a plain one (what the CPU tests
    drive a step's graph-ready form through)."""

    def __init__(self, parts, device):
        layout, size = [], 0
        for t in _tensors(parts):
            n = t.numel() * t.element_size()
            layout.append((size, n, t.dtype, tuple(t.shape)))
            size += -(-n // _ALIGN) * _ALIGN
        device = torch.device(device)
        cuda = device.type == "cuda"
        self.device_buf = torch.empty((size,), dtype=torch.uint8,
                                      device=device)
        self.host_buf = torch.empty((size,), dtype=torch.uint8,
                                    pin_memory=cuda)
        self.parts = _rebuild(parts, self._views(self.device_buf, layout))
        self._host = list(self._views(self.host_buf, layout))
        self._copied = torch.cuda.Event() if cuda else None
        self._pending = False

    @staticmethod
    def _views(buf, layout):
        return (buf[off:off + n].view(dtype).view(shape)
                for off, n, dtype, shape in layout)

    def load(self, parts) -> None:
        """Copy ``parts`` (CPU tensors of this signature) into the slot on
        the current stream."""
        if self._pending:
            self._copied.synchronize()
        for dst, src in zip(self._host, _tensors(parts)):
            dst.copy_(src)
        self.device_buf.copy_(self.host_buf,
                              non_blocking=self._copied is not None)
        if self._copied is not None:
            self._copied.record()
            self._pending = True


@dataclasses.dataclass
class CapturedGraph:
    graph: "torch.cuda.CUDAGraph"
    out: Tuple[torch.Tensor, ...]       # static outputs
    launches: Dict[str, int]            # kernel launches a replay makes
    pool_bytes: int                     # device memory its capture reserved


class CapturedCalls:
    """The capture's side stream, the eager warm-up on it, the capture
    with its launch accounting and the replay (see the module
    docstring).  ``stats``: seconds of eager warm-ups and of captures;
    captures and replays made; device memory the graphs hold.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: "global" unless a
    caller whose other threads touch the card while it captures sets
    "thread_local" (``distributed.STEP_GRAPHS``: NCCL's watchdog)."""

    capture_error_mode = "global"

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.stats = {"warmup_s": 0.0, "capture_s": 0.0, "captures": 0,
                      "replays": 0, "pool_bytes": 0}

    def warm_up(self, body: Callable[[], Tuple[torch.Tensor, ...]]):
        """``body()`` eagerly on the capture's stream, ordered after the
        current stream's work and before its next."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = body()
        cur.wait_stream(self.stream)
        self.stats["warmup_s"] += time.perf_counter() - t0
        return out

    def capture(self, body: Callable[[], Tuple[torch.Tensor, ...]],
                pool=None, generators: Sequence[torch.Generator] = ()
                ) -> CapturedGraph:
        """A CUDA graph of ``body()`` on the capture's stream, in ``pool``
        (a pool of its own if None); each of ``generators`` has its state
        registered, so that each replay draws fresh noise from the state
        the generator holds when the replay starts."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for generator in generators:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                  capture_error_mode=self.capture_error_mode):
                out = body()
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        add_launches(launches, -1)         # the capture ran nothing
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        self.stats["pool_bytes"] += pool_bytes
        return CapturedGraph(graph, out, launches, pool_bytes)

    def replay(self, graph: CapturedGraph) -> Tuple[torch.Tensor, ...]:
        """Replay ``graph`` on the current stream; its static outputs,
        which the next replay overwrites."""
        graph.graph.replay()
        add_launches(graph.launches)
        self.stats["replays"] += 1
        return graph.out


@dataclasses.dataclass
class _Entry:
    slot: Slots
    pinned: bool
    graph: Optional[CapturedGraph] = None


class ForwardGraphs(CapturedCalls):
    """The captured forwards of one model: ``fn(*parts) -> tensor`` on a
    loader item's parts (device tensors), one CUDA graph per signature
    (see the module docstring).  Calling it with a loader item on the CPU
    returns ``fn``'s output on the device; a replay's output is the
    graph's static tensor, valid until the next call."""

    KEEP = 2     # unpinned signatures kept (a predictor's fallback ones)

    def __init__(self, fn: Callable[..., torch.Tensor], device):
        super().__init__(device)
        self.fn = fn
        self._entries: "collections.OrderedDict[Tuple, _Entry]" = \
            collections.OrderedDict()
        self.stats["released"] = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __call__(self, parts: Sequence[GraphBatch],
                 pin: bool = False) -> torch.Tensor:
        """``fn`` on ``parts`` (CPU tensors): eagerly if their signature
        is new, else through its graph, captured at its second item.
        ``pin`` keeps the signature's graph for good."""
        sig = signature(parts)
        entry = self._entries.get(sig)
        if entry is None:
            entry = _Entry(Slots(parts, self.device), pin)
            self._entries[sig] = entry
            self._evict()

            def body():
                entry.slot.load(parts)
                return self.fn(*entry.slot.parts)
            return self.warm_up(body)
        self._entries.move_to_end(sig)
        entry.pinned |= pin
        if entry.graph is None:
            entry.graph = self.capture(
                lambda: (self.fn(*entry.slot.parts),))
        entry.slot.load(parts)
        return self.replay(entry.graph)[0]

    def release(self) -> None:
        """Free every signature's graph, pool and slot (pinned ones
        too)."""
        self._drop(list(self._entries))

    def _evict(self) -> None:
        """Drop the least recent unpinned signatures beyond ``KEEP``."""
        unpinned = [s for s, e in self._entries.items() if not e.pinned]
        self._drop(unpinned[:max(len(unpinned) - self.KEEP, 0)])

    def _drop(self, sigs) -> None:
        if not sigs:
            return
        torch.cuda.synchronize(self.device)
        for sig in sigs:
            graph = self._entries.pop(sig).graph
            if graph is not None:
                self.stats["pool_bytes"] -= graph.pool_bytes
                self.stats["released"] += 1
            del graph
        torch.cuda.empty_cache()      # give the freed pools back
