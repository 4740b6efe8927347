"""Optimizers: Adam, SGD and Ranger, with a settable learning rate, and
ReduceLROnPlateau (the JAX package's ``train/optim.py``).

Adam and SGD are torch's, with torch's defaults, which are the optax
settings the JAX package uses (betas (0.9, 0.999), eps 1e-8; plain SGD).

Ranger = gradient centralization, then the reference's exact RAdam
(betas (0.95, 0.999), eps 1e-5, N_sma threshold 5, eps added to sqrt(v)
with the bias correction folded into the step size, and bias-corrected
momentum alone while N_sma <= 5; ``optim.py:55-97``), then a step of
-lr, then Lookahead (every k steps the slow weights move halfway to the
fast ones and the fast ones are reset to them).

Gradient centralization subtracts the mean over every axis but the
output axis from each gradient of two or more dimensions.  The JAX
package centers over all axes but the last of its [in..., out] layout.
The port keeps the TripletMessage weights in that layout but stores the
Dense and GRU kernels transposed, [out, in] (``convert._LEAVES``), so
those are centered over the axes after the first.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Optional, Tuple

import torch

from ..convert import transposed_from_jax


def gc_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """The axes gradient centralization averages over for the parameter
    ``name`` of ``ndim`` dimensions (none for vectors)."""
    if ndim <= 1:
        return ()
    if transposed_from_jax(name):
        return tuple(range(1, ndim))
    return tuple(range(ndim - 1))


class Ranger(torch.optim.Optimizer):
    """RAdam + Lookahead + gradient centralization, the reference's
    ``ranger.py`` as the JAX package reimplements it.

    The step count ``t`` is a float64 tensor on the parameters' device
    (``param_groups[0]["step"]``), and the step's branches (N_sma over the
    threshold or not; a Lookahead sync every k steps) are selected with
    ``torch.where``, so a step makes no host synchronisation and a CUDA
    graph of it takes each branch as its replay's ``t`` says.  The
    scalars are computed in float64 and cast to float32 once, as the host
    scalars of the reference's step are."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr=1e-3, k: int = 6, alpha: float = 0.5,
                 betas: Tuple[float, float] = (0.95, 0.999),
                 eps: float = 1e-5, threshold: float = 5.0):
        named = list(named_params)
        defaults = dict(lr=lr, k=k, alpha=alpha, betas=betas, eps=eps,
                        threshold=threshold)
        super().__init__([p for _, p in named], defaults)
        self._gc = [gc_dims(n, p.dim()) for n, p in named]
        device = named[0][1].device if named else "cpu"
        self.param_groups[0]["step"] = torch.zeros(
            (), dtype=torch.float64, device=device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        lr, k, alpha = group["lr"], group["k"], group["alpha"]
        (b1, b2), eps = group["betas"], group["eps"]
        t = group["step"]
        t.add_(1.0)
        b2t = torch.pow(b2, t)
        n_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_max - 2.0 * t * b2t / (1.0 - b2t)
        bias1 = 1.0 - torch.pow(b1, t)
        # NaN where N_sma <= 4, where the other branch is taken
        rect = torch.sqrt((1.0 - b2t) * (n_sma - 4.0) / (n_max - 4.0)
                          * (n_sma - 2.0) / n_sma
                          * n_max / (n_max - 2.0)) / bias1
        rectified = n_sma > group["threshold"]
        sync = torch.remainder(t, k) == 0
        # the master parameters are float32
        rect_step, plain_step = (-lr * rect).float(), (-lr / bias1).float()
        for p, dims in zip(group["params"], self._gc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if dims:
                g = g - g.mean(dim=dims, keepdim=True)
            st = self.state[p]
            if not st:
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                st["slow"] = p.detach().clone()
            m, v, slow = st["exp_avg"], st["exp_avg_sq"], st["slow"]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.add_(torch.where(rectified, rect_step * m / v.sqrt().add_(eps),
                               plain_step * m))
            slow.copy_(torch.where(sync, slow + alpha * (p - slow), slow))
            p.copy_(torch.where(sync, slow, p))
        return loss


def make_optimizer(name: str, named_params, lr: float,
                   k: int = 6) -> torch.optim.Optimizer:
    """The named optimizer over ``named_params`` ((name, parameter)
    pairs, as ``model.named_parameters()`` gives them).  On the card the
    learning rate is a float32 tensor there, and Adam and SGD are torch's
    fused ones, Adam capturable: a step makes no host synchronisation, so
    a CUDA graph can hold it (``train/step_graph.py``), and
    :func:`set_learning_rate` reaches the graph's next replay.  On the
    CPU they are torch's defaults, with a float learning rate."""
    name = name.strip()
    named = list(named_params)
    params = [p for _, p in named]
    on_card = bool(params) and params[0].device.type == "cuda"
    if on_card:
        lr = torch.tensor(float(lr), dtype=torch.float32,
                          device=params[0].device)
    if name == "Adam":
        if on_card:
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, fused=True, capturable=True)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "SGD":
        return torch.optim.SGD(params, lr=lr, fused=True if on_card
                               else None)
    if name == "Ranger":
        return Ranger(named, lr=lr, k=k)
    raise ValueError(f"Error optimizer argv: {name!r}")


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate; a tensor learning rate (the
    card's) is written in place, so that a captured step reads it."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(opt: torch.optim.Optimizer, state: Dict) -> None:
    """``opt.load_state_dict(state)``, then the tensors of its groups (a
    tensor learning rate, Ranger's step count), which a checkpoint read
    to the CPU brings back there, moved to the parameters' device again:
    a step on the card must not read a CPU tensor."""
    opt.load_state_dict(state)
    for group in opt.param_groups:
        device = group["params"][0].device
        for key in ("lr", "step"):
            if isinstance(group.get(key), torch.Tensor):
                group[key] = group[key].to(device)


def state_digest(model: torch.nn.Module,
                 opt: torch.optim.Optimizer) -> str:
    """A SHA-256 of the training state's bits: every tensor of
    ``model.state_dict()`` (BatchNorm's statistics included) and of the
    optimizer's state, by name, shape, dtype and bytes.  Two states have
    one digest only where every tensor is bitwise equal: a parallel
    run's result.json holds every rank's, so that ranks and runs can be
    held against each other without their weights."""
    h = hashlib.sha256()
    tensors = list(model.state_dict().items()) + [
        (f"opt.{i}.{k}", v) for i, st in enumerate(opt.state.values())
        for k, v in st.items() if isinstance(v, torch.Tensor)]
    for name, t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class ReduceLROnPlateau:
    """Host-side torch ReduceLROnPlateau (mode='min'): new_lr =
    max(lr * factor, min_lr) after ``patience`` epochs without an
    improvement by a relative ``threshold``."""

    def __init__(self, factor: float = 0.7, patience: int = 20,
                 min_lr: float = 1e-6, threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: Optional[float] = None
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
            return lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> Dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: Dict) -> None:
        self.best = state["best"]
        self.num_bad = int(state["num_bad"])
