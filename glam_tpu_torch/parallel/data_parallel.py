"""Data parallelism over ranks: the counterpart of the JAX package's
``parallel/data_parallel.py``.

Each rank holds a replica of the model and its optimizer, takes its own
padded sub-batch of every global batch (``data/batching.py``, ``rank``)
and computes its loss and gradients; the gradients are summed over the
ranks, so every replica takes the same update.  The JAX package does the
same in one process with ``shard_map`` over a ``("data",)`` mesh.

The gradient of the global batch's loss: each rank's loss is a weighted
mean whose denominator is its weight w (``weight_fn``: the loss's mask
sum), so with W the sum of w over the ranks, scaling rank k's loss by
w_k / max(W, 1e-12) before its backward and summing the gradients gives
the single-process gradient of the global batch, all-padding sub-batches
included (w = 0).  ``weight_fn=None`` scales by 1 / ranks, the JAX
package's ``make_dp_train_step`` (``data_parallel.py:72-80``).  The
gradients go over in one flat buffer in parameter order, one
``all_reduce`` (SUM); BatchNorm's running statistics ride in the same
buffer and are averaged (JAX's ``pmean``), and so do the loss and one
flag a parameter saying whether the rank has its gradient.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..nn.norms import BatchNorm
from .distributed import all_reduce_sum


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


def global_weight(w: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's share w / max(sum of w over the ranks, 1e-12)."""
    total = all_reduce_sum(w.detach().float().reshape(1).clone(), group)
    return w / total.clamp(min=1e-12).reshape(())


def make_dp_train_step(model: torch.nn.Module, loss_fn: Callable,
                       optimizer, group=None,
                       weight_fn: Optional[Callable] = None,
                       forward: Optional[Callable] = None):
    """``step(parts, generator=None) -> loss``: one data-parallel
    optimizer step on this rank's sub-batch ``parts`` (a tuple of
    GraphBatches on the rank's device; labels and graph mask on the
    first).  Returns the global batch's loss, the same on every rank.
    ``forward(parts, generator)`` gives the model's float32 output
    (default: the model called on the parts)."""
    forward = forward or _default_forward(model)
    params = [p for p in model.parameters() if p.requires_grad]
    stats = running_stats(model)
    ranks = dist.get_world_size(group)

    def step(parts, generator=None):
        y, gmask = parts[0].y, parts[0].graph_mask
        scale = (1.0 / ranks if weight_fn is None
                 else global_weight(weight_fn(y, gmask), group))
        loss = loss_fn(forward(parts, generator), y, gmask) * scale
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # one flag a parameter: whether this rank has its gradient; a
        # parameter takes the sum wherever any rank had one, so the
        # replicas skip the same parameters
        flat = torch.cat(
            [p.grad.reshape(-1) if p.grad is not None
             else p.new_zeros(p.numel()) for p in params]
            + [b.reshape(-1) for b in stats]
            + [loss.new_tensor([float(p.grad is not None) for p in params]),
               loss.detach().reshape(1)])
        all_reduce_sum(flat, group)
        had = (flat[-1 - len(params):-1] > 0).tolist()
        off = 0
        for p, h in zip(params, had):
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p) if h else None
            off += n
        with torch.no_grad():
            for b in stats:
                n = b.numel()
                b.copy_(flat[off:off + n].view_as(b) / ranks)
                off += n
        optimizer.step()
        return flat[-1]

    return step


def make_dp_eval_step(model: torch.nn.Module, loss_fn: Callable,
                      group=None, weight_fn: Optional[Callable] = None,
                      forward: Optional[Callable] = None):
    """``step(parts) -> (out, loss)``: this rank's output on its
    sub-batch and the global batch's loss, sum over ranks of
    loss_k w_k / W (``weight_fn=None``: the mean over ranks, JAX's
    ``pmean``).  The caller sets evaluation mode and no_grad."""
    forward = forward or _default_forward(model)
    ranks = dist.get_world_size(group)

    def step(parts):
        y, gmask = parts[0].y, parts[0].graph_mask
        out = forward(parts, None)
        loss = loss_fn(out, y, gmask).float()
        w = (loss.new_ones(()) if weight_fn is None
             else weight_fn(y, gmask).float())
        both = all_reduce_sum(torch.stack([w, loss * w]), group)
        if weight_fn is None:
            return out, both[1] / ranks
        return out, both[1] / both[0].clamp(min=1e-12)

    return step
