"""CUDA graphs of the trainer's steps: the counterpart of the JAX
trainer's jitted steps (``glam_tpu/train/trainer.py:348-351``): one
dispatch for an optimizer step (``train_step``), for a group of S steps
over S stacked batches (``train_scan``, ``--scan_steps S``), and the same
for evaluation (``eval_step``, ``eval_scan``).

:class:`StepGraphs` owns, per batch signature (the shapes and dtypes of
every field of a loader item: a loader's budgets are pinned, so all its
batches share one):

  * the static input slots, one per batch of a group (:class:`Slots`):
    every field of a loader item is a view into one device buffer, which
    one non-blocking copy from one pinned host buffer fills;
  * the warm-up: the first group of a signature runs eagerly on the
    capture's side stream.  These are real steps on real batches (their
    losses count, their updates stay); they make the optimizer's state,
    the kernels' ticket buffers on that stream (``ops/kernels/common.py``)
    and the libraries' handles before anything is captured;
  * the graphs: a one-step graph over slot 0 and an S-step graph over S
    slots, captured on first use, the training ones sharing one memory
    pool and the evaluation ones another.  Each registers the trainer's
    ``torch.Generator``, so that each replay draws fresh Dropout masks and
    RReLU slopes (Philox offsets that advance with every replay, as the
    eager steps' do) rather than the captured ones;
  * the launch accounting: a capture runs nothing, so the kernel launches
    its wrappers count while it is captured are taken back and added again
    at every replay (``ops.kernels.add_launches``).

The batches come from the loaders' prefetch thread (``data/batching.py``)
as CPU tensors: that thread makes no CUDA call, so the default
``capture_error_mode="global"`` holds while it runs.  A failure to
capture raises; nothing continues eagerly in its place.  On the CPU, and
for the data-parallel and sharded trainers (whose gloo collectives are
staged through the host), the trainer runs its steps eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..data.graph import GraphBatch
from ..ops.kernels import add_launches, launch_counts

_ALIGN = 256     # bytes between the starts of two fields in a slot


def signature(parts: Sequence[GraphBatch]) -> Tuple:
    """The shapes and dtypes of every field of a loader item's parts."""
    return tuple((f.name, tuple(getattr(p, f.name).shape),
                  getattr(p, f.name).dtype)
                 for p in parts for f in dataclasses.fields(p))


def stackable(pending: Sequence[Sequence[GraphBatch]]) -> bool:
    """Whether every item of a group shares the first one's signature
    (the JAX trainer's ``_stackable``): only then one S-step graph takes
    the group."""
    first = signature(pending[0])
    return all(signature(p) == first for p in pending[1:])


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
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: Tuple[torch.Tensor, ...]       # static outputs, stacked per step
    launches: Dict[str, int]            # kernel launches a replay makes


class StepGraphs:
    """The captured steps of one trainer (see the module docstring).

    ``train_fn(parts) -> loss`` is one eager optimizer step on device
    tensors; ``eval_fn(parts) -> (out, loss)`` one evaluation forward.
    ``generator`` is the noise generator the training steps draw from."""

    def __init__(self, train_fn: Callable, eval_fn: Callable, device,
                 generator: torch.Generator):
        self.device = torch.device(device)
        self.fns = {"train": train_fn, "eval": eval_fn}
        self.generator = generator
        self.stream = torch.cuda.Stream(self.device)
        self.pools = {k: torch.cuda.graph_pool_handle() for k in self.fns}
        self._slots: Dict[Tuple, List[Slots]] = {}
        self._warm = set()
        self._graphs: Dict[Tuple, _Graph] = {}
        # seconds of eager warm-up groups and of captures; captures and
        # replays made; device memory the captures reserved
        self.stats = {"warmup_s": 0.0, "capture_s": 0.0, "captures": 0,
                      "replays": 0, "pool_bytes": 0}

    # -- public --------------------------------------------------------
    def train(self, group: Sequence[Sequence[GraphBatch]],
              stack: bool) -> torch.Tensor:
        """The optimizer steps of ``group`` (loader items on the CPU), in
        order: through one S-step graph if ``stack`` (S = len(group); the
        items share a signature), else through the one-step graph item by
        item.  Returns the losses [len(group)] on the device."""
        return self._group("train", group, stack)[0]

    def evaluate(self, group: Sequence[Sequence[GraphBatch]],
                 stack: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The evaluation forwards of ``group``, as :meth:`train` runs
        steps: (outputs [len(group), G, D], losses [len(group)]) on the
        device."""
        return self._group("eval", group, stack)

    # -- internals -----------------------------------------------------
    def _group(self, kind, group, stack: bool):
        if stack:
            return self._run(kind, group)
        outs = [self._run(kind, [parts]) for parts in group]
        return tuple(torch.cat(o) for o in zip(*outs))

    def _call(self, kind, parts):
        out = self.fns[kind](parts)
        return out if isinstance(out, tuple) else (out,)

    def _run(self, kind: str, group):
        """``group``'s items (one signature) through the graph of
        len(group) steps, or eagerly if it is the first group of its
        signature."""
        sig = signature(group[0])
        slots = self._slots.setdefault(sig, [])
        while len(slots) < len(group):
            slots.append(Slots(group[0], self.device))
        cur = torch.cuda.current_stream(self.device)
        if (kind, sig) not in self._warm:
            # eager, on the capture's stream, item by item through slot 0
            t0 = time.perf_counter()
            outs = []
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                for parts in group:
                    slots[0].load(parts)
                    outs.append(self._call(kind, slots[0].parts))
                outs = tuple(torch.stack(o) for o in zip(*outs))
            cur.wait_stream(self.stream)
            self._warm.add((kind, sig))
            self.stats["warmup_s"] += time.perf_counter() - t0
            return outs
        key = (kind, sig, len(group))
        if key not in self._graphs:
            self._graphs[key] = self._capture(kind, slots[:len(group)])
        graph = self._graphs[key]
        for slot, parts in zip(slots, group):
            slot.load(parts)
        graph.graph.replay()
        add_launches(graph.launches)
        self.stats["replays"] += 1
        # the static outputs are overwritten by the next replay
        return tuple(o.clone() for o in graph.out)

    def _capture(self, kind: str, slots: List[Slots]) -> _Graph:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if kind == "train":
            graph.register_generator_state(self.generator)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.graph(graph, pool=self.pools[kind],
                              stream=self.stream):
            outs = [self._call(kind, s.parts) for s in slots]
            out = tuple(torch.stack(o) for o in zip(*outs))
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        add_launches(launches, -1)         # the capture ran nothing
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        self.stats["pool_bytes"] += (torch.cuda.memory_reserved(self.device)
                                     - reserved)
        return _Graph(graph, out, launches)
