"""CUDA graphs of the trainers' steps: the counterpart of the JAX
trainer's jitted steps (``glam_tpu/train/trainer.py:348-351``): one
dispatch for an optimizer step (``train_step``), for a group of S steps
over S stacked batches (``train_scan``, ``--scan_steps S``), and the same
for evaluation (``eval_step``, ``eval_scan``); and of its data-parallel
and node-sharded steps (``jit(shard_map(...))``, ``trainer.py:353-420``,
``glam_tpu/train/sharded_pair_trainer.py:364-420``).

:class:`StepGraphs` is built on the capture core the predictors share
(``cuda_graphs.py``: the batch signature, the static input slots, the
side stream, the capture with its launch accounting, the replay).  It
owns, per batch signature:

  * the static input slots, one per batch of a group (``Slots``);
  * the warm-up: the first group of a signature runs eagerly on the
    capture's side stream.  These are real steps on real batches (their
    losses count, their updates stay); they make the optimizer's state,
    the kernels' ticket buffers on that stream, the libraries' handles
    and NCCL's communicators before anything is captured;
  * the graphs: a one-step graph over slot 0 and an S-step graph over S
    slots, captured on first use, the training ones sharing one memory
    pool and the evaluation ones another.  Each training graph registers
    the trainer's ``torch.Generator``, so that each replay draws fresh
    Dropout masks and RReLU slopes (Philox offsets that advance with
    every replay, as the eager steps' do) rather than the captured ones.

The one-process trainer's steps take it, and so do the node-sharded
trainer's under nccl (``sharded_pair_trainer.py``: one graph per budget
signature, the halo exchanges, the norms' all-reduces and the
gradients' broadcast inside).

:class:`RankStepGraphs` takes a data-parallel rank's steps
(``parallel/data_parallel.py``: ``local``, ``reduce``, ``apply``) in
the design its backend allows (``distributed.step_graphs_for``):

  * "whole" (nccl): one graph a step holding its all-reduce, and one
    S-step graph a full group with its S all-reduces, as the JAX
    package scans its data-parallel step; evaluation likewise;
  * "segmented" (gloo, ranks sharing a card): a graph of ``local``
    (forward, backward, the flat buffer), the eager all-reduce of that
    graph's static buffer, a graph of ``apply`` (the gradients into
    ``.grad``, BatchNorm's statistics, the fused optimizer step), step
    by step; evaluation a graph of the forward and [w, loss w], the
    all-reduce and a graph of the division.  All three run on the
    current stream: gloo records an event on it when called, copies the
    buffer to the host after that event, and makes the stream wait for
    its copy back before it returns, so the second graph reads the sum.

A rank reseeds its noise before every step, from (seed, step * D +
rank), as the JAX package folds ``step * D + axis_index`` into its key.
Reseeding reaches a replay: a registered generator's seed and offset are
read when the replay starts, so ``manual_seed`` before it gives the
eager step's draws.  An S-step graph draws step i from generator i of S,
each reseeded before the replay.  The gradient set of a signature is
the one its warm-up's eager steps read back (``DPTrainStep.had``).

The batches come from the loaders' prefetch thread (``data/batching.py``)
as CPU tensors: that thread makes no CUDA call, so the default
``capture_error_mode="global"`` holds while it runs; under nccl the
captures run in "thread_local" mode (``distributed.CAPTURE_ERROR_MODE``:
NCCL's watchdog).  A failure to capture raises; nothing continues
eagerly in its place.  On the CPU the trainers run their steps eagerly,
and so does a node-sharded rank under gloo.
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
                generators=[self.generator] if kind == "train" else [])
        for slot, parts in zip(slots, group):
            slot.load(parts)
        # the static outputs are overwritten by the next replay
        return tuple(o.clone() for o in self.replay(self._graphs[key]))


class RankStepGraphs(CapturedCalls):
    """The captured steps of one data-parallel rank (see the module
    docstring): ``train_step`` a ``DPTrainStep``, ``eval_step`` a
    ``DPEvalStep`` (or None), ``generator`` the rank's noise generator,
    ``design`` "whole" or "segmented", ``scan_steps`` the longest group
    a whole S-step graph takes, ``capture_error_mode`` the backend's."""

    def __init__(self, train_step, eval_step, device,
                 generator: torch.Generator, design: str,
                 scan_steps: int = 1, capture_error_mode: str = "global"):
        super().__init__(device)
        if design not in ("whole", "segmented"):
            raise ValueError(f"unknown step graph design {design!r}")
        self.design, self.capture_error_mode = design, capture_error_mode
        self.steps = {"train": train_step, "eval": eval_step}
        self.generators = [generator] + [
            torch.Generator(self.device)
            for _ in range(max(scan_steps, 1) - 1)]
        self.pools = {k: torch.cuda.graph_pool_handle() for k in self.steps}
        self._slots: Dict[Tuple, List[Slots]] = {}
        self._warm = set()
        self._had: Dict[Tuple, List[bool]] = {}
        self._graphs: Dict[Tuple, CapturedGraph] = {}

    # -- public --------------------------------------------------------
    def train(self, group: Sequence[Sequence[GraphBatch]], stack: bool,
              seeds: Sequence[int]) -> torch.Tensor:
        """The optimizer steps of ``group`` (loader items on the CPU), in
        order, step i's noise from seed ``seeds[i]``: through one S-step
        graph if ``stack`` and the design is whole, else step by step.
        Returns the global losses [len(group)] on the device."""
        return self._group("train", group, stack, seeds)[0]

    def evaluate(self, group: Sequence[Sequence[GraphBatch]],
                 stack: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The evaluation forwards of ``group``: (outputs [len(group), G,
        D], global losses [len(group)]) on the device."""
        return self._group("eval", group, stack, [None] * len(group))

    # -- internals -----------------------------------------------------
    def _group(self, kind, group, stack, seeds):
        sig = signature(group[0])
        slots = self._slots.setdefault(sig, [])
        n = len(group) if stack and self.design == "whole" else 1
        if n > len(self.generators):
            raise ValueError(f"a group of {n} steps, but graphs of at most "
                             f"{len(self.generators)}")
        while len(slots) < n:
            slots.append(Slots(group[0], self.device))
        if (kind, sig) not in self._warm:
            out = self._warm_up(kind, slots[0], group, seeds, sig)
            self._warm.add((kind, sig))
            return out
        if n > 1:
            return self._replay(kind, sig, slots[:n], group, seeds)
        outs = [self._replay(kind, sig, slots[:1], [item], [seed])
                for item, seed in zip(group, seeds)]
        return tuple(torch.cat(o) for o in zip(*outs))

    def _warm_up(self, kind, slot, group, seeds, sig):
        """The signature's first group of ``kind``, eagerly on the
        capture's stream through ``slot``; the gradient set the training
        steps read back becomes the signature's."""
        step, gen = self.steps[kind], self.generators[0]

        def body():
            outs = []
            for item, seed in zip(group, seeds):
                slot.load(item)
                if kind == "train":
                    gen.manual_seed(seed)
                    outs.append((step(slot.parts, gen),))
                else:
                    outs.append(step(slot.parts))
            return tuple(torch.stack(o) for o in zip(*outs))
        out = self.warm_up(body)
        if kind == "train":
            self._had[sig] = list(step.had)
        return out

    def _whole(self, kind, sig, slots):
        """The body of a whole graph over ``slots``: each step's local
        part, its all-reduce and its apply."""
        step, had = self.steps[kind], self._had.get(sig)
        outs = []
        for slot, gen in zip(slots, self.generators):
            if kind == "train":
                flat = step.local(slot.parts, gen, had)
                step.reduce(flat)
                outs.append((step.apply(flat, had),))
            else:
                out, both = step.local(slot.parts)
                step.reduce(both)
                outs.append((out, step.apply(both)))
        return tuple(torch.stack(o) for o in zip(*outs))

    def _graph(self, key, body, kind, generators=()):
        if key not in self._graphs:
            self._graphs[key] = self.capture(body, pool=self.pools[kind],
                                             generators=generators)
        return self._graphs[key]

    def _replay(self, kind, sig, slots, group, seeds):
        """``group`` through its graphs (captured on first use); the
        outputs cloned, since the next replay overwrites them."""
        step = self.steps[kind]
        gens = self.generators[:len(slots)] if kind == "train" else []
        if self.design == "whole":
            graph = self._graph((kind, sig, len(slots)),
                                lambda: self._whole(kind, sig, slots),
                                kind, gens)
            for slot, item, gen, seed in zip(slots, group, self.generators,
                                             seeds):
                slot.load(item)
                if seed is not None:
                    gen.manual_seed(seed)
            return tuple(o.clone() for o in self.replay(graph))
        slot, had = slots[0], self._had.get(sig)
        if kind == "train":
            local = self._graph((kind, sig, "local"), lambda: (step.local(
                slot.parts, gens[0], had),), kind, gens)
            apply = self._graph((kind, sig, "apply"), lambda: (step.apply(
                local.out[0], had),), kind)
            self.generators[0].manual_seed(seeds[0])
        else:
            local = self._graph((kind, sig, "local"),
                                lambda: step.local(slot.parts), kind)
            apply = self._graph((kind, sig, "apply"),
                                lambda: (step.apply(local.out[1]),), kind)
        slot.load(group[0])
        flat = self.replay(local)[-1]
        step.reduce(flat)               # eager, host-staged, in place
        loss = self.replay(apply)[0]
        return (local.out[0].clone()[None], loss.clone()[None]) \
            if kind == "eval" else (loss.clone()[None],)
