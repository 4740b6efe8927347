"""Data parallelism over ranks: the counterpart of the JAX package's
``parallel/data_parallel.py``.

Each rank holds a replica of the model and its optimizer, takes its own
padded sub-batch of every global batch (``data/batching.py``, ``rank``)
and computes its loss and gradients; the gradients are summed over the
ranks, so every replica takes the same update.  The JAX package does the
same in one process with ``shard_map`` over a ``("data",)`` mesh.

One collective a step.  Each rank's loss is a weighted mean whose
denominator is its weight w (``weight_fn``: the loss's mask sum;
``weight_fn=None``: w = 1, the JAX package's ``make_dp_train_step``,
``data_parallel.py:72-80``).  A rank's backward takes the gradient of
w_k loss_k, and one flat buffer in parameter order carries w_k grad
loss_k, BatchNorm's running statistics, w_k, w_k loss_k and one flag a
parameter (whether the rank has its gradient) through one sum over the
ranks (``distributed.all_reduce_sum``: one ``all_gather``, the ranks'
buffers added in rank order, the same bits on every rank and in every
run).  After it, with W the sum of w over the ranks,
the gradients divided by max(W, 1e-12) are the single-process gradient
of the global batch (all-padding sub-batches, w = 0, included: the JAX
trainer's weighted ``psum``, ``glam_tpu/train/trainer.py:368-398``), the
loss is sum of w_k loss_k / W, and the statistics divided by the rank
count are JAX's ``pmean``.  W comes over in the same buffer rather than
in an all-reduce of its own before the forward, which would split the
step in three segments around two host-staged collectives under gloo.

Each step is three parts (what a captured step replays,
``train/step_graph.py`` ``RankStepGraphs``): ``local`` (forward,
backward, pack), ``reduce`` (the all-reduce) and ``apply`` (unpack,
statistics, optimizer).  A parameter takes the summed gradient wherever
any rank has one, so the replicas skip the same parameters.  Called as
a function, a step runs the three eagerly and reads the flags back
(``had``); a captured step fixes that set at its signature's eager
warm-up and passes it to ``local`` and ``apply``, so that a replay
makes no host synchronisation and keeps one set of parameters with
gradients.  A parameter outside it keeps ``grad = None``, and Adam does
not move it.  The evaluation step is the forward and one all-reduce of
[w, loss w].
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..nn.norms import BatchNorm
from . import distributed


def _default_forward(model):
    return lambda parts, generator=None: model(*parts, generator=generator)


def running_stats(model: torch.nn.Module):
    """The running statistics of ``model``'s BatchNorm layers, in module
    order."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in m.buffers()]


def broadcast_state(model: torch.nn.Module, group=None, src: int = 0):
    """Give every rank rank ``src``'s parameters and buffers, in one
    flat broadcast (the replicas start equal, as the JAX package's
    replicated parameters do)."""
    tensors = [t for t in list(model.parameters()) + list(model.buffers())
               if t.is_floating_point()]
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src, group=group)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


class DPTrainStep:
    """One data-parallel optimizer step on this rank's sub-batch (see
    the module docstring).  ``step(parts, generator=None) -> loss``: the
    step on ``parts`` (a tuple of GraphBatches on the rank's device;
    labels and graph mask on the first), eagerly; returns the global
    batch's loss, the same on every rank.  ``forward(parts, generator)``
    gives the model's float32 output (default: the model called on the
    parts)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer, group=None, weight_fn: Optional[Callable] = None,
                 forward: Optional[Callable] = None):
        self.forward = forward or _default_forward(model)
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.group, self.weight_fn = group, weight_fn
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.stats = running_stats(model)
        self.ranks = dist.get_world_size(group)
        self._n_grad = sum(p.numel() for p in self.params)
        self._n_stats = sum(b.numel() for b in self.stats)
        self.had: Optional[List[bool]] = None   # the last eager step's set

    def __call__(self, parts, generator=None) -> torch.Tensor:
        flat = self.local(parts, generator)
        self.reduce(flat)
        self.had = (flat[-len(self.params):] > 0).tolist()
        return self.apply(flat, self.had)

    def local(self, parts, generator=None,
              had: Optional[Sequence[bool]] = None) -> torch.Tensor:
        """Forward and backward of w_k loss_k; the flat buffer [w_k grads
        | running statistics | w_k, w_k loss_k | flags].  With ``had``
        (the fixed set) the flags are left zero, and nothing waits for
        the host."""
        y, gmask = parts[0].y, parts[0].graph_mask
        loss = self.loss_fn(self.forward(parts, generator), y, gmask)
        w = (loss.new_ones(()) if self.weight_fn is None
             else self.weight_fn(y, gmask).to(loss.dtype))
        self.optimizer.zero_grad(set_to_none=True)
        (loss * w).backward()
        n = len(self.params)
        flags = (loss.new_zeros(n) if had is not None else loss.new_tensor(
            [float(p.grad is not None) for p in self.params]))
        return torch.cat(
            [p.grad.reshape(-1) if p.grad is not None
             else p.new_zeros(p.numel()) for p in self.params]
            + [b.reshape(-1) for b in self.stats]
            + [torch.stack([w, loss.detach() * w]), flags])

    def reduce(self, flat: torch.Tensor) -> None:
        """The step's one collective: ``flat`` summed over the ranks in
        rank order, in place."""
        distributed.all_reduce_sum(flat, self.group)

    def apply(self, flat: torch.Tensor, had: Sequence[bool]
              ) -> torch.Tensor:
        """Unpack the summed buffer: each parameter in ``had`` takes its
        gradient / W, the others none; the statistics their mean over the
        ranks; then the optimizer's step.  Returns the global loss."""
        at = self._n_grad + self._n_stats
        total = flat[at].clamp(min=1e-12)
        grads = flat[:self._n_grad].div_(total)
        off = 0
        for p, h in zip(self.params, had):
            n = p.numel()
            p.grad = grads[off:off + n].view_as(p) if h else None
            off += n
        with torch.no_grad():
            for b in self.stats:
                n = b.numel()
                b.copy_(flat[off:off + n].view_as(b) / self.ranks)
                off += n
        self.optimizer.step()
        return flat[at + 1] / total


def make_dp_train_step(model: torch.nn.Module, loss_fn: Callable,
                       optimizer, group=None,
                       weight_fn: Optional[Callable] = None,
                       forward: Optional[Callable] = None) -> DPTrainStep:
    """``step(parts, generator=None) -> loss``: a :class:`DPTrainStep`."""
    return DPTrainStep(model, loss_fn, optimizer, group, weight_fn, forward)


class DPEvalStep:
    """``step(parts) -> (out, loss)``: this rank's output on its
    sub-batch and the global batch's loss, sum over ranks of loss_k w_k
    / W (``weight_fn=None``: the mean over ranks, JAX's ``pmean``), in
    the three parts of :class:`DPTrainStep`.  The caller sets evaluation
    mode and no_grad."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 group=None, weight_fn: Optional[Callable] = None,
                 forward: Optional[Callable] = None):
        self.forward = forward or _default_forward(model)
        self.loss_fn, self.group, self.weight_fn = loss_fn, group, weight_fn

    def __call__(self, parts):
        out, both = self.local(parts)
        self.reduce(both)
        return out, self.apply(both)

    def local(self, parts):
        """(the output, [w_k, loss_k w_k])."""
        y, gmask = parts[0].y, parts[0].graph_mask
        out = self.forward(parts, None)
        loss = self.loss_fn(out, y, gmask).float()
        w = (loss.new_ones(()) if self.weight_fn is None
             else self.weight_fn(y, gmask).float())
        return out, torch.stack([w, loss * w])

    def reduce(self, both: torch.Tensor) -> None:
        distributed.all_reduce_sum(both, self.group)

    @staticmethod
    def apply(both: torch.Tensor) -> torch.Tensor:
        return both[1] / both[0].clamp(min=1e-12)


def make_dp_eval_step(model: torch.nn.Module, loss_fn: Callable,
                      group=None, weight_fn: Optional[Callable] = None,
                      forward: Optional[Callable] = None) -> DPEvalStep:
    """``step(parts) -> (out, loss)``: a :class:`DPEvalStep`."""
    return DPEvalStep(model, loss_fn, group, weight_fn, forward)
