"""CUDA graphs of the trainer's steps: the counterpart of the JAX
trainer's jitted steps (``glam_tpu/train/trainer.py:348-351``): one
dispatch for an optimizer step (``train_step``), for a group of S steps
over S stacked batches (``train_scan``, ``--scan_steps S``), and the same
for evaluation (``eval_step``, ``eval_scan``).

:class:`StepGraphs` is built on the capture core the predictors share
(``cuda_graphs.py``: the batch signature, the static input slots, the
side stream, the capture with its launch accounting, the replay).  It
owns, per batch signature:

  * the static input slots, one per batch of a group (``Slots``);
  * the warm-up: the first group of a signature runs eagerly on the
    capture's side stream.  These are real steps on real batches (their
    losses count, their updates stay); they make the optimizer's state,
    the kernels' ticket buffers on that stream and the libraries'
    handles before anything is captured;
  * the graphs: a one-step graph over slot 0 and an S-step graph over S
    slots, captured on first use, the training ones sharing one memory
    pool and the evaluation ones another.  Each training graph registers
    the trainer's ``torch.Generator``, so that each replay draws fresh
    Dropout masks and RReLU slopes (Philox offsets that advance with
    every replay, as the eager steps' do) rather than the captured ones.

The batches come from the loaders' prefetch thread (``data/batching.py``)
as CPU tensors: that thread makes no CUDA call, so the default
``capture_error_mode="global"`` holds while it runs.  A failure to
capture raises; nothing continues eagerly in its place.  On the CPU, and
for the data-parallel and sharded trainers (whose gloo collectives are
staged through the host), the trainer runs its steps eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..cuda_graphs import CapturedCalls, CapturedGraph, Slots, signature
from ..data.graph import GraphBatch


def stackable(pending: Sequence[Sequence[GraphBatch]]) -> bool:
    """Whether every item of a group shares the first one's signature
    (the JAX trainer's ``_stackable``): only then one S-step graph takes
    the group."""
    first = signature(pending[0])
    return all(signature(p) == first for p in pending[1:])


class StepGraphs(CapturedCalls):
    """The captured steps of one trainer (see the module docstring).

    ``train_fn(parts) -> loss`` is one eager optimizer step on device
    tensors; ``eval_fn(parts) -> (out, loss)`` one evaluation forward.
    ``generator`` is the noise generator the training steps draw from."""

    def __init__(self, train_fn: Callable, eval_fn: Callable, device,
                 generator: torch.Generator):
        super().__init__(device)
        self.fns = {"train": train_fn, "eval": eval_fn}
        self.generator = generator
        self.pools = {k: torch.cuda.graph_pool_handle() for k in self.fns}
        self._slots: Dict[Tuple, List[Slots]] = {}
        self._warm = set()
        self._graphs: Dict[Tuple, CapturedGraph] = {}

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

    def _steps(self, kind, slots, items=None):
        """The calls of ``kind`` over ``slots`` (each loaded with its item
        of ``items`` first, if given), their outputs stacked."""
        outs = []
        for i, slot in enumerate(slots):
            if items is not None:
                slot.load(items[i])
            outs.append(self._call(kind, slot.parts))
        return tuple(torch.stack(o) for o in zip(*outs))

    def _run(self, kind: str, group):
        """``group``'s items (one signature) through the graph of
        len(group) steps, or eagerly if it is the first group of its
        signature."""
        sig = signature(group[0])
        slots = self._slots.setdefault(sig, [])
        while len(slots) < len(group):
            slots.append(Slots(group[0], self.device))
        if (kind, sig) not in self._warm:
            # eager, on the capture's stream, item by item through slot 0
            out = self.warm_up(lambda: self._steps(
                kind, slots[:1] * len(group), group))
            self._warm.add((kind, sig))
            return out
        key = (kind, sig, len(group))
        if key not in self._graphs:
            self._graphs[key] = self.capture(
                lambda: self._steps(kind, slots[:len(group)]),
                pool=self.pools[kind],
                generator=self.generator if kind == "train" else None)
        for slot, parts in zip(slots, group):
            slot.load(parts)
        # the static outputs are overwritten by the next replay
        return tuple(o.clone() for o in self.replay(self._graphs[key]))
