"""Training engine: train and eval steps, the epoch loop with early
stop, ReduceLROnPlateau, best checkpoints, resume, and the parseable
result line.  The port of the JAX package's ``train/trainer.py``
(``Trainer``, ``make_trainer``).  The steps and the epoch loop are
generic over a loader item's parts (``Trainer._as_parts``): one
``GraphBatch`` here, a (g1, g2) pair in ``pair_trainer.PairTrainer``,
which swaps the loaders, the loss and the metric heads; the labels and
the graph mask are the first part's.

Each optimizer step is one forward, one backward and one update, on the
trainer's device (``cuda`` unless the caller passes ``device="cpu"``).
The epoch loop groups the batches as the JAX trainer does
(``trainer.py:417-475``, ``--scan_steps`` S, default 8): a full group of
S batches of one shape is one dispatch, any other group one dispatch a
batch, and evaluation likewise (``_gather``).  On the card a dispatch is
the replay of a CUDA graph (``train/step_graph.py``: the counterpart of
``jax.jit(train_step)`` and of ``train_scan``'s ``lax.scan``), a
data-parallel rank's too (``RankStepGraphs``, in the design its backend
allows: one graph a step or group with its all-reduce inside under
nccl, two graphs a step around an eager all-reduce under gloo); on the
CPU the same groups run eagerly, batch by batch.
``GLAM_TRAIN_STATS=1`` adds the JAX trainer's per-epoch line: edges/s
through the loop (a trailing device synchronisation included) and the
share of it spent waiting on the prefetch thread.
``--dtype`` sets the compute dtype (``float32``, ``bfloat16`` or
``float16``), as the JAX trainer's mixed precision (``trainer.py:262-320``)
does: the master parameters and the optimizer stay float32; the forward
and backward, training and evaluation alike, run on cast copies of the
parameters and of the batch's node and edge features
(``torch.func.functional_call``), so the gradients arrive in float32
through the casts; the loss is computed in float32 from the output cast
up.  The kernels stay float32: each call site casts its inputs up and
its output back (``nn/convs.py``, ``nn/readouts.py``).
Dropout masks and RReLU slopes are drawn from the trainer's
``torch.Generator``, which lives on that device and is seeded from
``seed``.  Training steps run the model in ``train()`` mode (BatchNorm
takes batch statistics and moves its running ones), evaluation in
``eval()`` mode (running statistics), as the JAX trainer threads its
``batch_stats``.  Checkpoints are torch files in the run directory, the
``state_dict`` in each with the BatchNorm running statistics:

  best_save.pt   {"args", "state_dict", "records"}, the format of
                 ``serve.save_checkpoint``, so ``Predictor`` serves it
  final_save.pt  the same, after the last epoch
  last_save.pt   the whole training state, for ``resume``

Data parallelism (``--n_devices`` D > 1; the JAX trainer's
``_build_dp_steps``, ``trainer.py:354-420``): the trainer is one rank of
a process group of D ranks (``parallel/distributed.py``), each on its own
device and sub-batch of every global batch (``data/batching.py``), with
the weighted steps of ``parallel/data_parallel.py`` (weights from
:func:`make_weight_fn`, or the pair trainer's).  A rank reseeds its noise
generator before every step from (seed, step * D + rank), the
counterpart of ``fold_in(rng, step * D + axis_index)``.  Evaluation runs
at a batch of ``max((32 // D) * D, D)``; the outputs are gathered in the
JAX package's order (each global batch rank 0's sub-batch first) and the
loss is sum over ranks of loss w / W, so every rank reaches the same
metrics, learning rate and early stop.  Rank 0 makes the run directory
and alone writes the log, the checkpoints and ``result.json``
(``kernel_launches_by_rank`` holds every rank's launches); every rank
reads the best checkpoint back.

Each run appends to ``log.txt``, whose last line is the
``{loss_info}|{test_result}|{val_result}`` triple of the JAX package
(``trainer.py:682``), and writes ``result.json``.  ``pasp`` evaluates
a regression model's robustness on ``physprop_perturb``.

Task trainers (one class, behaviour keyed by ``task``):
  regression       out [G,1]; criterion(out, y); RMSE/R2/CI metrics
  binary_nan       out [G,T*2] -> (G,T,2) softmax CE path
  binary_nan_bce   out [G,T] logits; masked BCEWithLogits (y >= 0)
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import shutil
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import GraphLoader, max_graph_nodes, prefetch
from ..data.graph import GraphBatch
from ..nn.model import Architecture, model_config_from_args
from ..ops.kernels import launch_counts
from ..parallel import data_parallel, distributed
from ..serve import resolve_device, save_checkpoint
from .losses import get_loss
from .metrics import binary_metrics_multi_target_nan, regression_metrics
from .optim import (ReduceLROnPlateau, get_learning_rate,
                    load_optimizer_state, make_optimizer, set_learning_rate,
                    state_digest)
from .step_graph import RankStepGraphs, StepGraphs, stackable

# a trial has diverged when its loss or outputs are non-finite or absurdly
# large but finite (an lr=1e8 run reaches ~1e27 without a NaN)
_DIVERGE_LIMIT = 1e15


def _diverged(*values) -> bool:
    return any(not np.isfinite(v) or abs(float(v)) > _DIVERGE_LIMIT
               for v in values)


def _utc_run_id(seed: int) -> str:
    ts = datetime.now(timezone.utc).strftime("%Y-%m-%d_%H:%M:%S.%f")[:-3]
    return f"{ts}_seed_{seed}"


def _new_run_dir(logs_dir: Path, seed: int,
                 suffix: str = "") -> Tuple[str, Path]:
    """(run id, its directory, made now): a run id (ending in ``suffix``)
    whose directory no other run has made.  Trials started together (an
    AutoML search's) can draw one millisecond's id; ``mkdir`` is atomic,
    so the later one takes the next millisecond's instead of sharing the
    directory."""
    logs_dir.mkdir(parents=True, exist_ok=True)
    while True:
        run_id = _utc_run_id(seed) + suffix
        try:
            (logs_dir / run_id).mkdir()
            return run_id, logs_dir / run_id
        except FileExistsError:
            time.sleep(0.001)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


def compute_dtype(args: Dict) -> torch.dtype:
    """The ``--dtype`` of ``args``; raises on a name not in
    ``COMPUTE_DTYPES``."""
    name = str(args.get("dtype", "float32"))
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unknown --dtype {name!r}; have "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def compute_forward(model: torch.nn.Module, parts, dtype: torch.dtype,
                    generator=None) -> torch.Tensor:
    """``model``'s float32 output on ``parts`` (a tuple of GraphBatches),
    computed in ``dtype``: the float32 master parameters and the batches'
    features are cast inside the differentiated computation, so
    gradients reach the masters in float32."""
    if dtype == torch.float32:
        return model(*parts, generator=generator)
    params = {n: p.to(dtype) for n, p in model.named_parameters()}
    out = torch.func.functional_call(
        model, params, tuple(p.cast(dtype) for p in parts),
        {"generator": generator})
    return out.float()


def check_supported(args: Dict) -> None:
    """Raise on an unknown ``--dtype``."""
    compute_dtype(args)


def make_loss_fn(task: str, loss_name: str, num_tasks: int):
    """``loss(outputs [G, D], y [G, T], graph_mask) -> scalar``."""
    criterion = get_loss(loss_name)

    if task == "regression":
        def loss_fn(out, y, gmask):
            pred = out.reshape(-1)
            return criterion(pred, y[:, 0], weight=gmask.to(pred.dtype))
    elif task == "binary_nan_bce":
        def loss_fn(out, y, gmask):
            mask = (y >= 0) & gmask[:, None]
            return criterion(out, y.clamp(min=0.0),
                             weight=mask.to(out.dtype))
    elif task == "binary_nan":
        def loss_fn(out, y, gmask):
            logits = out.reshape(y.shape[0], num_tasks, 2)
            mask = (y >= 0) & gmask[:, None]
            return criterion(logits, y.clamp(min=0.0),
                             weight=mask.to(out.dtype))
    else:
        raise ValueError(f"unknown task {task!r}")
    return loss_fn


def make_weight_fn(task: str):
    """A rank's loss weight, the denominator of its loss's weighted mean
    (the JAX trainer's ``make_weight_fn``): the count of labelled targets
    of real graphs for ``binary_nan``/``binary_nan_bce``, else of real
    graphs."""
    if task in ("binary_nan", "binary_nan_bce"):
        def weight_fn(y, gmask):
            return ((y >= 0) & gmask[:, None]).float().sum()
    else:
        def weight_fn(y, gmask):
            return gmask.float().sum()
    return weight_fn


def noise_seed(seed: int, index: int) -> int:
    """The noise generator's seed for step-and-rank ``index`` of a
    data-parallel run seeded with ``seed``."""
    return (int(seed) % 2 ** 31) * 2 ** 32 + int(index)


class Trainer:
    """Single-graph trainer; see the module docstring."""

    TASK = "regression"

    def __init__(self, args: Dict, model: torch.nn.Module, train_graphs,
                 valid_graphs, test_graphs=None, print_log: bool = True,
                 work_dir: Optional[str] = None, device="cuda"):
        check_supported(args)
        self.args = dict(args)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.print_log = print_log
        self.start = time.time()
        self.task = self.args.get("task", self.TASK)
        self.compute_dtype = compute_dtype(self.args)
        self.num_tasks = int(self.args.get("num_tasks", 1))
        seed = int(self.args.get("seed", 1234))
        self.n_devices = int(self.args.get("n_devices", 1) or 1)
        self.rank = 0
        if self.n_devices > 1:
            self.rank, ranks = distributed.world()
            if ranks != self.n_devices:
                raise RuntimeError(
                    f"--n_devices {self.n_devices} needs a process group "
                    f"of {self.n_devices} ranks (found {ranks}): launch "
                    "through glam_tpu_torch.run, or call parallel."
                    "distributed.initialize_distributed in each rank")
        self.is_main = self.rank == 0
        self.eval_batch = max((32 // self.n_devices) * self.n_devices,
                              self.n_devices)

        self._make_loaders(train_graphs, valid_graphs, test_graphs)
        self.loss_fn = self._make_loss()
        self.optimizer = make_optimizer(
            self.args.get("optim", "Adam"), self.model.named_parameters(),
            float(self.args.get("lr", 1e-3)), k=int(self.args.get("k", 6)))
        self.scheduler = ReduceLROnPlateau(
            factor=float(self.args.get("lr_reduce_rate", 0.7)),
            patience=int(self.args.get("lr_reduce_patience", 20)),
            min_lr=1e-6)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0            # optimizer steps taken
        self.scan_steps = int(self.args.get("scan_steps", 8))
        if self.n_devices > 1:
            data_parallel.broadcast_state(self.model)
            weight_fn = self._make_weight()
            self._dp_train = data_parallel.make_dp_train_step(
                self.model, self.loss_fn, self.optimizer,
                weight_fn=weight_fn, forward=self.forward)
            self._dp_eval = data_parallel.make_dp_eval_step(
                self.model, self.loss_fn, weight_fn=weight_fn,
                forward=self.forward)
        self.step_graphs, self.step_graphs_reason = self._make_step_graphs()
        self.records: Dict[str, List] = {"val_losses": []}
        # per epoch: optimizer steps, molecules and seconds of training
        self.epoch_stats: List[Dict] = []
        self._start_epoch = 0
        self._early_stop_cnt = 0

        base = Path(work_dir) if work_dir else Path.cwd()
        logs = base / f"log_{self.args.get('dataset', 'run')}"
        run_id = [_new_run_dir(logs, seed)[0] if self.is_main else None]
        if self.n_devices > 1:
            torch.distributed.broadcast_object_list(run_id, 0)
        self.run_id, self.log_save_dir = run_id[0], logs / run_id[0]

        n_params = sum(p.numel() for p in self.model.parameters())
        device_name = (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu")
        self.log(msgs=[f"\t{k}:{v}\n" for k, v in self.args.items()])
        self.log(f"save id: {self.run_id}")
        self.log(f"run device: {self.device} ({device_name})")
        self.log("train set num:{}    valid set num:{}    test set num: {}"
                 .format(len(train_graphs), len(valid_graphs),
                         len(test_graphs) if test_graphs else 0))
        self.log("total parameters:" + str(n_params))
        self.log(f"step graphs: {self.step_graphs is not None} "
                 f"({self.step_graphs_reason}); scan_steps "
                 f"{self.scan_steps}")

    # -- wiring hooks (PairTrainer replaces these) ----------------------
    def _split(self):
        """The loaders' data-parallel arguments."""
        return {"n_devices": self.n_devices, "rank": self.rank}

    def _make_loaders(self, train_graphs, valid_graphs, test_graphs):
        nt = self.num_tasks
        self.train_loader = GraphLoader(
            train_graphs, int(self.args.get("batch_size", 32)), nt,
            shuffle=True, seed=int(self.args.get("seed", 1234)),
            **self._split())
        self.valid_loader = self._eval_loader(valid_graphs)
        self.test_loader = (self._eval_loader(test_graphs)
                            if test_graphs else None)

    def _eval_loader(self, graphs):
        return GraphLoader(graphs, self.eval_batch, self.num_tasks,
                           **self._split())

    def _make_loss(self):
        return make_loss_fn(self.task, self.args.get("loss", "mse"),
                            self.num_tasks)

    def _make_weight(self):
        return make_weight_fn(self.task)

    @staticmethod
    def _as_parts(batch) -> Tuple[GraphBatch, ...]:
        """A loader item as a tuple of GraphBatches: (batch,) for a
        single-graph loader, (g1, g2) for a pair loader."""
        if isinstance(batch, GraphBatch):
            return (batch,)
        return tuple(batch)

    def _to_device(self, batch) -> Tuple[GraphBatch, ...]:
        return tuple(b.to(self.device) for b in self._as_parts(batch))

    def _make_step_graphs(self):
        """(the trainer's ``StepGraphs``, a data-parallel rank's
        ``RankStepGraphs``, or None on the CPU; why)."""
        if self.n_devices == 1:
            if self.device.type != "cuda":
                return None, ("a CPU has no CUDA graphs: the steps run "
                              "eagerly")
            return (StepGraphs(self._step, self._eval_step, self.device,
                               self.generator),
                    "one process on the card: steps and evaluations replay "
                    "CUDA graphs")
        backend = torch.distributed.get_backend()
        design, why = distributed.step_graphs_for(backend, self.device.type)
        why = f"--n_devices {self.n_devices}, backend {backend}: {why}"
        if design is None:
            return None, why
        return RankStepGraphs(
            self._dp_train, self._dp_eval, self.device, self.generator,
            design, self.scan_steps,
            distributed.CAPTURE_ERROR_MODE[backend]), f"{design}: {why}"

    def _noise_seed(self, step: int) -> int:
        """A data-parallel rank's noise seed for optimizer step ``step``
        (from 1)."""
        return noise_seed(self.args.get("seed", 1234),
                          (step - 1) * self.n_devices + self.rank)

    # ------------------------------------------------------------------
    def forward(self, parts, generator=None) -> torch.Tensor:
        """The model's float32 output on ``parts`` (a tuple of
        GraphBatches) in the compute dtype (:func:`compute_forward`)."""
        return compute_forward(self.model, parts, self.compute_dtype,
                               generator)

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on a batch (a ``GraphBatch`` or a tuple of
        them) already on the device; returns the loss, still on the
        device (with data parallelism: the global batch's, this rank's
        batch being its sub-batch)."""
        parts = self._as_parts(batch)
        self.step += 1
        if self.n_devices > 1:
            self.generator.manual_seed(self._noise_seed(self.step))
            return self._dp_train(parts, self.generator).detach()
        return self._step(parts)

    def _step(self, parts) -> torch.Tensor:
        """One optimizer step on ``parts`` on the device, no host
        synchronisation (what ``StepGraphs`` captures); the loss."""
        out = self.forward(parts, self.generator)
        loss = self.loss_fn(out, parts[0].y, parts[0].graph_mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _eval_step(self, parts):
        """(the float32 output, the loss) of one evaluation forward."""
        out = self.forward(parts)
        return out, self.loss_fn(out, parts[0].y, parts[0].graph_mask)

    def _full_group(self, pending) -> bool:
        """Whether ``pending`` is one dispatch (the JAX trainer's
        ``flush``): S = --scan_steps > 1 items of one shape."""
        return (len(pending) == self.scan_steps > 1
                and stackable(pending))

    def _train_group(self, pending) -> torch.Tensor:
        """The optimizer steps of a group of loader items (on the CPU);
        their losses [len(pending)] on the device."""
        if self.step_graphs is None:
            return torch.stack([self.train_step(self._to_device(p))
                                for p in pending])
        first = self.step + 1
        self.step += len(pending)
        if self.n_devices > 1:
            return self.step_graphs.train(
                pending, self._full_group(pending),
                [self._noise_seed(first + i) for i in range(len(pending))])
        return self.step_graphs.train(pending, self._full_group(pending))

    def _eval_group(self, pending):
        """(outputs [n, G, D], losses [n]) of a group of n loader items."""
        if self.step_graphs is not None:
            return self.step_graphs.evaluate(pending,
                                             self._full_group(pending))
        step = self._dp_eval if self.n_devices > 1 else self._eval_step
        res = [step(self._to_device(p)) for p in pending]
        return (torch.stack([o for o, _ in res]),
                torch.stack([l for _, l in res]))

    def train_iterations(self) -> float:
        """One epoch of steps in groups of --scan_steps; the per-batch
        mean loss."""
        self.model.train()
        stats = os.environ.get("GLAM_TRAIN_STATS", "0") == "1"
        losses, pending = [], []
        n_mol = n_edges = 0
        t_fetch = 0.0
        t0 = time.perf_counter()
        it = prefetch(iter(self.train_loader))
        while True:
            t1 = time.perf_counter()
            batch = next(it, None)
            t_fetch += time.perf_counter() - t1
            if batch is None:
                break
            parts = self._as_parts(batch)
            n_mol += int(parts[0].graph_mask.sum())
            n_edges += sum(int(p.edge_mask.sum()) for p in parts)
            pending.append(parts)
            if len(pending) == max(self.scan_steps, 1):
                losses.append(self._train_group(pending))
                pending = []
        if pending:
            losses.append(self._train_group(pending))
        values = torch.cat(losses).tolist() if losses else []
        if self.n_devices > 1:      # the global batches' molecules, edges
            n_mol, n_edges = (int(v) for v in distributed.all_reduce_sum(
                torch.tensor([n_mol, n_edges], device=self.device)).tolist())
        dt = time.perf_counter() - t0
        self.epoch_stats.append({"steps": len(values), "molecules": n_mol,
                                 "seconds": dt})
        if values:
            self.log("\tbatch 0 training loss: {:.5f}".format(values[0]),
                     with_time=True)
            self.log(f"\ttrain stats: {n_mol} molecules in {dt:.3f} s = "
                     f"{n_mol / max(dt, 1e-9):.1f} molecules/s",
                     with_time=True)
            if stats:
                self.log(f"\ttrain stats: {n_edges:.3e} edges in {dt:.2f}s "
                         f"= {n_edges / max(dt, 1e-9):.3e} edges/s, "
                         f"prefetch stall {t_fetch / max(dt, 1e-9):.1%}",
                         with_time=True)
        return float(np.mean(values)) if values else 0.0

    def _gather(self, mode: str):
        loader = self.valid_loader if mode == "valid" else self.test_loader
        self.model.eval()
        outs, losses, ys, masks = [], [], [], []
        pending = []

        def flush():
            out, loss = self._eval_group(pending)
            outs.extend(out.unbind(0))
            losses.append(loss)
            ys.extend(p[0].y for p in pending)
            masks.extend(p[0].graph_mask for p in pending)
            pending.clear()

        with torch.inference_mode():
            for batch in prefetch(iter(loader)):
                pending.append(self._as_parts(batch))
                if len(pending) == max(self.scan_steps, 1):
                    flush()
            if pending:
                flush()
            loss = torch.cat(losses).double().cpu().numpy()
            if self.n_devices > 1:
                outs, ys, masks = self._merge_ranks(outs, ys, masks)
            out = torch.cat(outs).cpu().numpy()
            y = torch.cat(ys).cpu().numpy()
            m = torch.cat(masks).cpu().numpy()
        return out[m], y[m], float(np.mean(loss))

    def _merge_ranks(self, outs, ys, masks):
        """Every rank's per-batch outputs, labels and graph masks, in the
        JAX package's ``_merge_devices`` order: each batch's sub-batches
        in rank order.  One all_gather; every rank gets them all."""
        width, tasks = outs[0].shape[1], ys[0].shape[1]
        local = torch.stack([torch.cat([o, y.to(o.device),
                                        m[:, None].float().to(o.device)], 1)
                             for o, y, m in zip(outs, ys, masks)])
        every = distributed.all_gather(local)       # [D, batches, G, ...]
        rows = every.transpose(0, 1).reshape(-1, local.shape[-1])
        return ([rows[:, :width]], [rows[:, width:width + tasks]],
                [rows[:, -1] > 0.5])

    def valid_iterations(self, mode: str = "valid"):
        out, y, mean_loss = self._gather(
            "valid" if mode == "valid" else
            ("test" if self.test_loader else "valid"))
        if mode != "inference" and (not np.isfinite(out).all()
                                    or np.abs(out).max() > _DIVERGE_LIMIT):
            # diverged parameters: report an inf-loss sentinel
            return float("inf"), {"diverged": 1.0}
        if self.task == "regression":
            pred = out.reshape(-1)
            tgt = y[:, 0]
            if mode == "inference":
                return tgt, pred
            return mean_loss, regression_metrics(tgt, pred)
        if self.task == "binary_nan_bce":
            score = 1.0 / (1.0 + np.exp(-out))
            if mode == "inference":
                return score, y
            return mean_loss, binary_metrics_multi_target_nan(y, score)
        # binary_nan (2-logit-per-task)
        logits = out.reshape(out.shape[0], self.num_tasks, 2)
        ex = np.exp(logits - logits.max(-1, keepdims=True))
        score = (ex / ex.sum(-1, keepdims=True))[..., 1]
        pred = logits.argmax(-1)
        if mode == "inference":
            return y, score, pred
        return mean_loss, binary_metrics_multi_target_nan(y, score, pred)

    # ------------------------------------------------------------------
    def train(self):
        self.log("Training start...")
        early_stop_cnt = self._early_stop_cnt
        start_epoch = self._start_epoch
        epochs = int(self.args.get("epochs", 30))
        patience = int(self.args.get("early_stop_patience", 50))
        epoch = start_epoch
        # replay the shuffle sequence: a resumed run sees the batch order
        # a straight-through run would have at this epoch
        self.train_loader.set_epoch(start_epoch)
        for epoch in range(start_epoch, epochs):
            trn_loss = self.train_iterations()
            val_loss, result = self.valid_iterations()
            if _diverged(trn_loss, val_loss):
                self.log(f"Epoch:{epoch} diverged "
                         f"(trn_loss:{trn_loss} val_loss:{val_loss}); "
                         "stopping training early.", with_time=True)
                break
            lr = get_learning_rate(self.optimizer)
            new_lr = self.scheduler.step(val_loss, lr)
            if new_lr != lr:
                set_learning_rate(self.optimizer, new_lr)
            self.log("Epoch:{} trn_loss:{:.5f} val_loss:{:.5f} "
                     "val_result:{} lr_cur:{:.7f}".format(
                         epoch, trn_loss, val_loss, result, new_lr),
                     with_time=True)
            self.records["val_losses"].append(val_loss)
            if val_loss == min(self.records["val_losses"]):
                self.save_ckpt(epoch)
                early_stop_cnt = 0
            else:
                early_stop_cnt += 1
            self.save_resume_ckpt(epoch, early_stop_cnt)
            if 0 < patience < early_stop_cnt:
                self.log("Early stop hitted!")
                break
        self.save_ckpt(epoch, final_save=True)

    def train_and_test(self):
        self.train()
        self.log("Testing...")
        self.load_best_ckpt()
        val_loss, val_result = self.valid_iterations(mode="valid")
        test_loss, test_result = self.valid_iterations(mode="test")
        self.log(msg=str(self.args))
        loss_info = {"testloss": float(test_loss), "valloss": float(val_loss)}
        val_new = {"val" + k: v for k, v in val_result.items()}
        self.log(f"{loss_info}|{test_result}|{val_new}")
        mine = (launch_counts(), self._graphs_record(),
                state_digest(self.model, self.optimizer))
        by_rank = [mine]
        if self.n_devices > 1:
            by_rank = [None] * self.n_devices
            torch.distributed.all_gather_object(by_rank, mine)
        if self.is_main:
            self._write_structured_result(
                loss_info, test_result, val_new, [r[0] for r in by_rank],
                [r[1] for r in by_rank], [r[2] for r in by_rank])
        return loss_info, test_result, val_new

    def _graphs_record(self) -> Dict:
        """This process's step graphs: whether its steps replayed them,
        why, and their stats."""
        return {"step_graphs": self.step_graphs is not None,
                "reason": self.step_graphs_reason,
                "stats": (dict(self.step_graphs.stats)
                          if self.step_graphs else None)}

    def _write_structured_result(self, loss_info, test_result, val_new,
                                 launches_by_rank, graphs_by_rank,
                                 digests_by_rank):
        """result.json in the run dir and a record appended to
        <work_dir>/results.jsonl: the config, the results, the epochs
        and optimizer steps trained, the seconds, the kernels' launches
        (this process's, and every rank's) and every rank's
        ``state_digest`` at the end."""
        record = {
            "run_id": self.run_id,
            "dataset": self.args.get("dataset"),
            "note": self.args.get("note"),
            "seed": self.args.get("seed"),
            "config": {k: v for k, v in self.args.items()
                       if k != "model_cfg"},
            "loss": loss_info,
            "test": test_result,
            "val": val_new,
            "epochs_run": len(self.records["val_losses"]),
            "epochs_trained": len(self.epoch_stats),
            "optimizer_steps": sum(e["steps"] for e in self.epoch_stats),
            # each loader's batches (global batches with data parallelism)
            "batches": {"train": len(self.train_loader),
                        "valid": len(self.valid_loader),
                        "test": len(self.test_loader)
                        if self.test_loader else 0},
            # wall seconds since the trainer was made, and of them those
            # of the training epochs' steps
            "seconds": time.time() - self.start,
            "train_seconds": sum(e["seconds"] for e in self.epoch_stats),
            # this process's kernel launches: a trial's own, since a
            # trial process trains one run
            "kernel_launches": launch_counts(),
            # whether the steps and evaluations replayed CUDA graphs, why,
            # and the graphs' warm-up and capture seconds, captures,
            # replays and pool bytes
            "step_graphs": self.step_graphs is not None,
            "step_graphs_reason": self.step_graphs_reason,
            "step_graph_stats": (dict(self.step_graphs.stats)
                                 if self.step_graphs else None),
            # each rank's: whether it replayed graphs, why, their stats
            "step_graphs_by_rank": graphs_by_rank,
            "scan_steps": self.scan_steps,
            "kernel_launches_by_rank": launches_by_rank,
            # each rank's weights, statistics and optimizer state at the
            # end, as optim.state_digest: equal where the bits are
            "state_digest_by_rank": digests_by_rank,
        }
        try:
            with open(self.log_save_dir / "result.json", "w") as f:
                json.dump(record, f, indent=1)
            with open(self.log_save_dir.parent / "results.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass

    # ------------------------------------------------------------------
    def gen_test_batch(self, path="other/test_batch.npz") -> str:
        """Save the first validation batch's tensors (every field of the
        ``GraphBatch``; ``g1_``/``g2_``-prefixed for a pair batch) with
        ``np.savez``, as a fixture (the JAX trainer's
        ``gen_test_batch``); returns ``path``."""
        parts = self._as_parts(next(iter(self.valid_loader)))
        arrays = {}
        for i, part in enumerate(parts):
            prefix = f"g{i + 1}_" if len(parts) > 1 else ""
            for f in dataclasses.fields(part):
                value = getattr(part, f.name)
                if value is not None:
                    arrays[prefix + f.name] = value.cpu().numpy()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **arrays)
        return str(path)

    def write_datasets(self, out_dir=".") -> None:
        """Write each split's SMILES and first label to
        ``<out_dir>/{train,valid,test}.csv`` (``smiles,label``; a pair
        split's ``smiles,partner,label``), as the JAX trainer's
        ``write_datasets`` does with pandas."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for name, loader in (("train", self.train_loader),
                             ("valid", self.valid_loader),
                             ("test", self.test_loader)):
            if loader is None:
                continue
            graphs = getattr(loader, "graphs", None)
            if graphs is not None:
                rows = [(g.smi, float(g.y.reshape(-1)[0])) for g in graphs]
                header = ("smiles", "label")
            else:
                rows = [(p[0].smi, p[1].smi, float(p[0].y.reshape(-1)[0]))
                        for p in loader.pairs]
                header = ("smiles", "partner", "label")
            with open(out / f"{name}.csv", "w", newline="") as f:
                writer = csv.writer(f, lineterminator="\n")
                writer.writerow(header)
                writer.writerows(rows)

    # ------------------------------------------------------------------
    def pasp(self) -> Dict[int, float]:
        """PASP robustness of a regression model (the JAX package's
        ``Trainer.pasp``): for perturbation levels 1-3, Delta_RMSE =
        rmse(P, P') - rmse(Q, Q'), P and P' the model's predictions on
        the original and perturbed test molecules, Q and Q' their labels.
        Returns {level: Delta_RMSE}."""
        from ..data.perturb import perturb_test

        results = {}
        for level in (1, 2, 3):
            self.log(f"Run model for perturbed test level {level}...")
            M, M_prime, Q, Q_prime = perturb_test(
                self.args["dataset_root"], self.args["dataset"], level)
            saved = self.test_loader
            self.test_loader = self._eval_loader(M)
            _, P = self.valid_iterations(mode="inference")
            self.test_loader = self._eval_loader(M_prime)
            _, P_prime = self.valid_iterations(mode="inference")
            self.test_loader = saved
            l_pp = regression_metrics(P, P_prime)
            l_qq = regression_metrics(Q, Q_prime)
            self.log(f"L(P, P') is {l_pp}, and\n L(Q, Q') is {l_qq}")
            delta = l_pp["rmse"] - l_qq["rmse"]
            self.log(f"Delta_RMSE={delta}")
            results[level] = delta
        return results

    # ------------------------------------------------------------------
    def save_ckpt(self, epoch: int, final_save: bool = False):
        if not self.is_main:
            return
        name = "final_save.pt" if final_save else "best_save.pt"
        save_checkpoint(self.log_save_dir, self.model, self.args, which=name,
                        records=self.records)
        self.log(f"Model saved at epoch {epoch}")

    def save_resume_ckpt(self, epoch: int, early_stop_cnt: int):
        """The whole training state, so that ``resume()`` continues as a
        straight-through run would: weights, optimizer state (learning
        rate included), scheduler, noise generator, early-stop counter
        and epoch."""
        if not self.is_main:
            return
        payload = {
            "args": json.dumps(self.args),
            "records": json.dumps(self.records),
            "state_dict": {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": json.dumps(self.scheduler.state_dict()),
            "generator": self.generator.get_state(),
            "epoch": epoch,
            "early_stop_cnt": early_stop_cnt,
            "step": self.step,
        }
        torch.save(payload, self.log_save_dir / "last_save.pt")

    def resume(self, run_dir) -> int:
        """Restore the training state from ``<run_dir>/last_save.pt`` (or
        a direct path) and continue that run's directory.  Returns the
        next epoch, where ``train()`` continues.  The run goes on bit for
        bit as a straight-through run, on the card too: every sum of a
        step runs in a fixed order (``ops/segment.py``), the optimizer's
        state, its device-side step counts included, comes back to the
        parameters' device, and the noise generator's state is restored
        before the step graphs are captured, whose replays read it."""
        path = Path(run_dir)
        if path.is_dir():
            path = path / "last_save.pt"
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved_args = json.loads(payload["args"])
        for key in ("dataset", "batch_size", "seed", "model_cfg", "e_dim",
                    "hid_dim_alpha", "mol_block", "mol_readout",
                    "message_steps", "optim", "task"):
            if key in saved_args and key in self.args \
                    and saved_args[key] != self.args[key]:
                raise ValueError(
                    f"resume mismatch on {key!r}: checkpoint has "
                    f"{saved_args[key]!r}, this run has {self.args[key]!r}")
        self.records = json.loads(payload["records"])
        self.scheduler.load_state_dict(json.loads(payload["scheduler"]))
        self.model.load_state_dict(payload["state_dict"])
        load_optimizer_state(self.optimizer, payload["optimizer"])
        self.generator.set_state(payload["generator"])
        self._early_stop_cnt = int(payload["early_stop_cnt"])
        self._start_epoch = int(payload["epoch"]) + 1
        self.step = int(payload.get("step", 0))
        fresh = self.log_save_dir
        self.log_save_dir = path.parent
        if fresh != self.log_save_dir and self.is_main:
            shutil.rmtree(fresh, ignore_errors=True)
        self.run_id = self.log_save_dir.name
        self.log(f"Resumed from {path} at epoch {self._start_epoch}")
        return self._start_epoch

    def load_best_ckpt(self):
        if self.n_devices > 1:      # rank 0 has written it
            torch.distributed.barrier()
        path = self.log_save_dir / "best_save.pt"
        if not path.exists():
            # a run that diverged before its first finite val loss saved
            # no best checkpoint; keep the current weights
            self.log("No best checkpoint saved (diverged run?); "
                     "keeping current params")
            return
        self.log(f"The best ckpt is {path}")
        self.load_ckpt(path)

    def load_ckpt(self, path):
        self.log(f"Ckpt loading: {path}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.args.update(json.loads(payload["args"]))
        self.records = json.loads(payload["records"])
        self.model.load_state_dict(payload["state_dict"])

    # ------------------------------------------------------------------
    def log(self, msg=None, msgs=None, with_time=False):
        if not self.print_log or not self.is_main:
            return
        if with_time and msg is not None:
            el = time.time() - self.start
            msg = msg + " time elapsed {:.2f} hrs ({:.1f} mins)".format(
                el / 3600.0, el / 60.0)
        with open(self.log_save_dir / "log.txt", "a+") as f:
            if msgs:
                f.writelines([m if m.endswith("\n") else m + "\n"
                              for m in msgs])
            if msg is not None:
                f.write(str(msg) + "\n")
                print(msg)


def make_trainer(args: Dict, dataset, trainer_kind: str,
                 work_dir: Optional[str] = None,
                 model_overrides: Optional[Dict] = None,
                 device="cuda") -> Trainer:
    """Model and trainer from a flat config dict and a MolDataset; the
    weights are drawn from a generator seeded with ``seed``."""
    args = dict(args)
    args["task"] = trainer_kind
    args["num_tasks"] = dataset.num_tasks
    overrides = dict(model_overrides or {})
    overrides.setdefault("max_nodes", max_graph_nodes(dataset.graphs))
    overrides.setdefault("mol_in_dim", dataset.num_node_features)
    overrides.setdefault("mol_edge_in_dim", dataset.num_edge_features)
    overrides.setdefault("out_dim", args.get("out_dim", 1))
    cfg = model_config_from_args(args, **overrides)
    args["model_cfg"] = dataclasses.asdict(cfg)  # self-describing ckpts
    model = Architecture(cfg, torch.Generator().manual_seed(
        int(args.get("seed", 1234))))
    return Trainer(args, model, dataset.train, dataset.val, dataset.test,
                   work_dir=work_dir, device=device)
