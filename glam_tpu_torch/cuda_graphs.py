"""CUDA graphs of the port's hot calls: the counterpart of the JAX
package's one compiled executable per batch shape (``jax.jit``'s cache).
What the trainer's captured steps (``train/step_graph.py``) and the
predictors' captured forwards (``serve.py``) share:

  * :func:`signature`: the shapes and dtypes of every field of a loader
    item's parts.  A loader's budgets are pinned, so all its batches
    share one;
  * :class:`Slots`: the static input tensors of one loader item, each
    field a view into one device buffer that one non-blocking copy from
    one pinned host buffer fills;
  * :class:`CapturedCalls`: a side stream on which a signature's first
    call runs eagerly (the warm-up, which makes the kernels' ticket
    buffers on that stream, ``ops/kernels/common.py``, the optimizer's
    state and the libraries' handles before anything is captured), the
    capture into a memory pool, and the replay.  A capture runs nothing,
    so the kernel launches its wrappers count while it is captured are
    taken back and added again at every replay
    (``ops.kernels.add_launches``);
  * :class:`ForwardGraphs`: a forward-only cache, one graph per
    signature, each in a pool of its own, for the predictors: a
    signature's first item runs eagerly on the side stream, its second
    is captured, later ones replay.  Pinned signatures stay; of the
    others only the most recent ``ForwardGraphs.KEEP`` do, and a dropped
    one's graph, pool and slot are freed.

A failure to capture raises; nothing continues eagerly in its place.  A
capture and its replays run under the grad mode the caller sets, which
must be the eager path's (under ``inference_mode`` the card's segment
sums take their in-order path, so a replay equals the eager forward
bitwise).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .data.graph import GraphBatch
from .ops.kernels import add_launches, launch_counts

_ALIGN = 256     # bytes between the starts of two fields in a slot


def signature(parts: Sequence[GraphBatch]) -> Tuple:
    """The shapes and dtypes of every field of a loader item's parts."""
    return tuple((f.name, tuple(getattr(p, f.name).shape),
                  getattr(p, f.name).dtype)
                 for p in parts for f in dataclasses.fields(p))


class Slots:
    """Static device tensors of one loader item: each field of each part
    is a view into one device byte buffer, filled by one non-blocking copy
    from one pinned host buffer, which the host fills field by field once
    the previous copy out of it has run."""

    def __init__(self, parts: Sequence[GraphBatch], device):
        layout, size = [], 0
        for part in parts:
            fields = []
            for f in dataclasses.fields(part):
                t = getattr(part, f.name)
                n = t.numel() * t.element_size()
                fields.append((f.name, size, n, t.dtype, tuple(t.shape)))
                size += -(-n // _ALIGN) * _ALIGN
            layout.append(fields)
        self.device_buf = torch.empty((size,), dtype=torch.uint8,
                                      device=device)
        self.host_buf = torch.empty((size,), dtype=torch.uint8,
                                    pin_memory=True)
        self.parts = self._views(self.device_buf, layout)
        self._host_parts = self._views(self.host_buf, layout)
        self._copied = torch.cuda.Event()
        self._pending = False

    @staticmethod
    def _views(buf, layout):
        return tuple(GraphBatch(**{
            name: buf[off:off + n].view(dtype).view(shape)
            for name, off, n, dtype, shape in fields}) for fields in layout)

    def load(self, parts: Sequence[GraphBatch]) -> None:
        """Copy ``parts`` (CPU tensors of this signature) into the slot on
        the current stream."""
        if self._pending:
            self._copied.synchronize()
        for dst, src in zip(self._host_parts, parts):
            for f in dataclasses.fields(src):
                getattr(dst, f.name).copy_(getattr(src, f.name))
        self.device_buf.copy_(self.host_buf, non_blocking=True)
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
    captures and replays made; device memory the graphs hold."""

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
                pool=None, generator: Optional[torch.Generator] = None
                ) -> CapturedGraph:
        """A CUDA graph of ``body()`` on the capture's stream, in ``pool``
        (a pool of its own if None); ``generator``'s state is registered,
        so that each replay draws fresh noise."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.graph(graph, pool=pool, stream=self.stream):
            out = body()
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
