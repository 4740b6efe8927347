"""DTI training with the protein tower node-sharded over ranks: the
counterpart of the JAX package's ``train/sharded_pair_trainer.py``.

``python -m glam_tpu_torch.run --dataset bindingdb_c ... --pro_shards N``
starts N ranks (one process each, ``parallel/distributed.py``); each
builds this trainer.  The molecule tower runs whole on every rank, the
protein contact-map graph is cut into N node shards with the halo
exchange (``parallel/sharded_model.py``), and every step's backward runs
through the collectives, so that each rank takes the same optimizer step
(its gradients are rank 0's, :func:`sharded_model.sync_grads`).

The JAX trainer's contract: per-epoch log lines, early stop on the val
loss, ReduceLROnPlateau, best and final checkpoints, ``resume``, and the
parseable ``{loss}|{test}|{val}`` final line.  The checkpoints are the
dense ``PairArchitecture``'s (``best_save.pt``, as
``serve.save_checkpoint`` writes them), so ``PairPredictor`` serves them
unchanged.  Rank 0 alone writes the run directory, the log and the
checkpoints; every rank computes every step and evaluation, since each
takes part in the collectives.

  * one pair a step by default; ``--pair_batch B`` trains B pairs a
    step, their protein shards packed into one local graph a rank; the
    loss is the weighted mean over the batch, a short last chunk padded
    with weight-0 repeats of its last pair (``_item``): the repeats'
    molecules leave BatchNorm's statistics (their node mask is off) and
    their proteins weigh 0 in the protein tower's;
  * every protein is planned at the corpus's largest shapes
    (``sharded_model.corpus_budgets``); ``--halo auto`` chooses one plan
    for the corpus;
  * end_norm must be '_None' (it is set so); pre_norm and flat_norm
    '_None' (:func:`sharded_config_ok`); the protein tower's flat layer
    and the head are deterministic, the molecule tower honours its
    dropouts; graph dropout and train-mode RReLU in the protein tower
    come from ``make_stochastic_inputs``.  Noise is drawn from torch
    generators seeded from ``seed + 1`` (the molecule tower's on the
    rank's device, the protein tower's on the CPU), not from JAX's keys;
  * ``--probe_compile`` is accepted and does nothing (nothing compiles).

Under nccl (one card a rank) every step and evaluation forward is the
replay of a CUDA graph (``train/step_graph.py`` ``StepGraphs``, one per
budget signature: every protein of the corpus packs to one shape,
``sharded_model.Shard``), its halo exchanges, the norms' and readouts'
all-reduces and the gradients' broadcast inside
(``distributed.sharded_step_graphs_for``).  A step's inputs enter the
graph through static slots: the molecule batch, the rank's packed
shard, the labels, the weights and the protein tower's noise, which is
drawn on the host from the CPU generator as the eager step draws it, so
that captured and eager training see the same noise.  Under gloo and on
the CPU the steps run eagerly on the same inputs (``_item``,
``_on_device``), and the log says why.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.graph import pad_graphs
from ..nn.activations import activation_key
from ..nn.blocks import parse_dropout
from ..nn.model import PairArchitecture, model_config_from_args
from ..ops.kernels import launch_counts
from ..parallel import distributed
from ..parallel.data_parallel import broadcast_state
from ..parallel.sharded_model import (corpus_budgets, local_noise,
                                      make_sharded_pair_forward,
                                      make_stochastic_inputs, pack_shards,
                                      shard_at, sync_grads)
from ..serve import resolve_device, save_checkpoint
from .metrics import binary_metrics, regression_metrics, screening_metrics
from .optim import (ReduceLROnPlateau, get_learning_rate,
                    load_optimizer_state, make_optimizer, set_learning_rate,
                    state_digest)
from .pair_trainer import _set_pair_max_nodes
from .step_graph import StepGraphs
from .trainer import _new_run_dir


def sharded_config_ok(config: dict) -> bool:
    """Whether a sampled DTI config fits the sharded path: pre_norm and
    flat_norm '_None' (the solver resamples otherwise)."""
    if str(config.get("pre_norm", "_None")).strip() != "_None":
        return False
    if str(config.get("flat_norm", "_None")).strip() != "_None":
        return False
    return True


def pair_losses(task: str, class_weights=None):
    """``loss(logits [B, out], y [B]) -> [B]``, the JAX sharded trainer's
    per-pair losses: squared error (pair_regression), BCE with logits
    (pair_binary_bce), else 2-logit cross entropy, class-weighted for
    pair_screening when the dataset has class weights."""
    def loss(logits, y):
        if task == "pair_regression":
            return (logits[:, 0] - y) ** 2
        if task == "pair_binary_bce":
            z = logits[:, 0]
            return z.clamp(min=0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
        tgt = y.long().clamp(0, logits.shape[1] - 1)
        ce = torch.logsumexp(logits, -1) - logits.gather(1, tgt[:, None])[:, 0]
        if task == "pair_screening" and class_weights is not None:
            ce = ce * torch.as_tensor(np.asarray(class_weights),
                                      dtype=ce.dtype, device=ce.device)[tgt]
        return ce

    return loss


class ShardedPairTrainer:
    """Giant-protein DTI trainer; one instance a rank."""

    def __init__(self, args: Dict, dataset, task: str = "pair_binary",
                 work_dir: Optional[str] = None, device="cuda"):
        args = dict(args)
        args["task"] = task
        args["num_tasks"] = 1
        args["out_dim"] = 1 if task in ("pair_regression",
                                        "pair_binary_bce") else 2
        self.args, self.task = args, task
        self.start = time.time()
        self.class_weights = getattr(dataset, "class_weights", None)
        n = int(args.get("pro_shards", 2))
        self.rank, ranks = distributed.world()
        if ranks != n:
            raise RuntimeError(
                f"--pro_shards {n} needs a process group of {n} ranks "
                f"(found {ranks}): launch through glam_tpu_torch.run, or "
                "call parallel.distributed.initialize_distributed in each "
                "rank")
        self.n_shards, self.is_main = n, self.rank == 0
        self.device = resolve_device(device)
        self.halo = str(args.get("halo", "a2a"))
        if self.halo not in ("a2a", "ring", "auto"):
            raise ValueError(f"halo must be 'a2a', 'ring' or 'auto', "
                             f"got {self.halo!r}")
        for key in ("pre_norm", "flat_norm"):
            if str(args.get(key, "_None")).strip() != "_None":
                raise ValueError(
                    f"--pro_shards: {key} must be '_None' (the sharded "
                    "protein tower has no pre/flat norm)")
        if str(args.get("dtype", "float32")) != "float32":
            raise ValueError("--pro_shards trains in float32 only")
        # the sharded head's requirement, in the flat args too, so that
        # everything downstream sees the config that trained
        args["end_norm"] = "_None"
        overrides = {
            "mol_in_dim": dataset.num_node_features,
            "mol_edge_in_dim": dataset.num_edge_features,
            "pro_in_dim": dataset.pro_num_node_features,
            "pro_edge_in_dim": dataset.pro_num_edge_features,
            "out_dim": args["out_dim"], "end_norm": "_None"}
        pairs = dataset.train + dataset.val + dataset.test
        _set_pair_max_nodes(overrides, pairs, hetero=True)
        cfg = model_config_from_args(args, **overrides)
        args["model_cfg"] = dataclasses.asdict(cfg)
        self.cfg = cfg
        seed = int(args.get("seed", 1234))
        self.model = PairArchitecture(
            cfg, hetero=True,
            generator=torch.Generator().manual_seed(seed)).to(self.device)
        broadcast_state(self.model)
        self.forward = make_sharded_pair_forward(self.model)

        # one padded shape for every sample
        mol_nb = 8 * -(-max(p[0].nodes.shape[0] for p in pairs) // 8)
        mol_eb = 8 * -(-max(p[0].senders.shape[0] for p in pairs) // 8)
        self._mol_budgets = (mol_nb + 8, mol_eb + 8)
        # every protein padded to the corpus's largest shapes, one plan
        self._pro_budgets = corpus_budgets([p[1] for p in pairs], n,
                                           self.halo)
        _, _, hb, ring, plan = self._pro_budgets
        self._halo_note = None
        if self.halo == "auto":
            self._halo_note = (f"halo auto -> {plan} (ring rows "
                               f"{sum(ring)} vs a2a rows {n * hb})")
        self.halo = plan
        self._plans: Dict[int, tuple] = {}
        self._packed: Dict[int, object] = {}         # B = 1: on the host
        self._on_card: Dict[int, object] = {}        # and on the device
        self.splits = {"train": dataset.train, "valid": dataset.val,
                       "test": dataset.test}

        self.optimizer = make_optimizer(
            args.get("optim", "Adam"), self.model.named_parameters(),
            float(args.get("lr", 1e-3)), k=int(args.get("k", 6)))
        self._drop_rate = parse_dropout(args.get("graph_do", "_None()"))
        self._has_bn = cfg.graph_norm.strip() == "_BatchNorm"
        # BatchNorm trains on batch statistics, so with it the train
        # forward runs in training mode even at dropout rate 0
        self.stochastic = (self._drop_rate > 0.0 or self._has_bn
                           or activation_key(args.get("graph_act", "CELU"))
                           == "RReLU")
        self.B = max(1, int(args.get("pair_batch", 1)))
        self.loss = pair_losses(task, self.class_weights)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.pro_generator = torch.Generator().manual_seed(seed + 1)
        self.scheduler = ReduceLROnPlateau(
            factor=float(args.get("lr_reduce_rate", 0.7)),
            patience=int(args.get("lr_reduce_patience", 20)))
        backend = torch.distributed.get_backend()
        design, why = distributed.sharded_step_graphs_for(backend,
                                                          self.device.type)
        self.step_graphs = None
        self.step_graphs_reason = f"--pro_shards {n}, backend {backend}: {why}"
        if design is not None:
            self.step_graphs_reason = f"{design}: {self.step_graphs_reason}"
            self.step_graphs = StepGraphs(self._train, self._infer,
                                          self.device, self.generator)
            self.step_graphs.capture_error_mode = \
                distributed.CAPTURE_ERROR_MODE[backend]
        self._wait = 0
        self._start_epoch = 1
        self._best_state = self._state_copy()
        self.steps = 0
        self.forwards = 0
        self.epochs_trained = 0

        base = Path(work_dir or ".") / f"log_{args.get('dataset', 'dti')}"
        run_id = [_new_run_dir(base, seed, f"_shard{n}")[0]
                  if self.is_main else None]
        torch.distributed.broadcast_object_list(run_id, 0)
        self.run_id, self.log_save_dir = run_id[0], base / run_id[0]
        self.records = {"val_losses": [], "trn_losses": []}
        self.log(f"sharded DTI trainer: {n} shards, task={task}, "
                 f"stochastic={self.stochastic}, pair_batch={self.B}")
        if self._halo_note:
            self.log(self._halo_note)
        self.log(f"step graphs: {self.step_graphs is not None} "
                 f"({self.step_graphs_reason})")
        self.log(str({k: v for k, v in args.items() if k != "model_cfg"}))

    # ------------------------------------------------------------------
    def _plan(self, pro):
        """This rank's slice of ``pro``'s shard arrays at the corpus
        budgets (numpy), cached a protein."""
        key = id(pro)
        if key not in self._plans:
            self._plans[key] = shard_at(pro, self.n_shards, self.rank,
                                        self._pro_budgets)
        return self._plans[key]

    def _item(self, chunk, train: bool = False):
        """(molecule batch, this rank's packed protein shard, labels [B],
        weights [B], noise) of up to B pairs, on the CPU: a short chunk
        is padded with repeats of its last pair at weight 0; ``noise``
        is the protein tower's (drop, slope) for a training step of a
        stochastic model, drawn now, else None."""
        pairs = list(chunk)
        n_real = len(pairs)
        w = [1.0] * n_real + [0.0] * (self.B - n_real)
        pairs += [pairs[-1]] * (self.B - n_real)
        nb, eb = self._mol_budgets
        mol_b = pad_graphs([p[0] for p in pairs], self.B, self.B * nb,
                           self.B * eb, num_tasks=1)
        if n_real < self.B:      # the repeats leave BatchNorm's statistics
            mol_b = dataclasses.replace(
                mol_b, node_mask=mol_b.node_mask & (mol_b.node_graph
                                                    < n_real))
        if self.B == 1:
            key = id(pairs[0][1])
            if key not in self._packed:
                self._packed[key] = pack_shards([self._plan(pairs[0][1])],
                                                self.n_shards)
            shard = self._packed[key]
        else:
            shard = pack_shards([self._plan(p[1]) for p in pairs],
                                self.n_shards)
        y = torch.tensor([float(p[0].y.reshape(-1)[0]) for p in pairs])
        noise = self._noise(shard) if train and self.stochastic else None
        return mol_b, shard, y, torch.tensor(w), noise

    def _on_device(self, item):
        """``item`` on the device (a B = 1 shard moved once a protein)."""
        mol_b, shard, y, w, noise = item
        if self.B == 1:
            key = id(shard)
            if key not in self._on_card:
                self._on_card[key] = shard.to(self.device)
            shard = self._on_card[key]
        else:
            shard = shard.to(self.device)
        move = lambda t: t.to(self.device)  # noqa: E731
        return (move(mol_b), shard, move(y), move(w),
                None if noise is None else tuple(map(move, noise)))

    def _noise(self, shard):
        """This rank's protein-tower noise for the step's B pairs, each
        pair's drawn over the padded global node count (D * Nl), on the
        CPU."""
        n_global = self.n_shards * shard.n_local
        noises = [make_stochastic_inputs(
            self.pro_generator, n_global, self.cfg.hid_dim,
            self.cfg.message_steps, self.n_shards, rate=self._drop_rate)
            for _ in range(self.B)]
        return local_noise(noises, self.rank)

    # ------------------------------------------------------------------
    def train_step(self, item) -> torch.Tensor:
        """One optimizer step on an item of :meth:`_item` (on the CPU):
        through its signature's graph under nccl, else eagerly; returns
        the weighted mean loss (the same on every rank)."""
        self.model.train(self.stochastic)
        self.forwards += 1
        self.steps += 1
        if self.step_graphs is not None:
            return self.step_graphs.train([item], False)[0]
        return self._train(self._on_device(item))

    def _train(self, item) -> torch.Tensor:
        """The step on ``item`` on the device: what a graph holds."""
        mol_b, shard, y, w, noise = item
        logits = self.forward(mol_b, shard,
                              self.generator if self.stochastic else None,
                              noise, bn_weight=w)
        loss = (self.loss(logits, y) * w).sum() / w.sum().clamp(min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sync_grads(self.model)
        self.optimizer.step()
        return loss.detach()

    def _infer(self, item):
        """(logits [B, out], per-pair losses [B]) of ``item`` on the
        device, in the mode the caller set."""
        mol_b, shard, y = item[:3]
        logits = self.forward(mol_b, shard)
        return logits, self.loss(logits, y)

    def evaluate(self, item):
        """(logits, per-pair losses) of an item of :meth:`_item` in
        evaluation mode, through its graph under nccl."""
        self.model.eval()
        self.forwards += 1
        with torch.no_grad():
            if self.step_graphs is not None:
                logits, per = self.step_graphs.evaluate([item], False)
                return logits[0], per[0]
            return self._infer(self._on_device(item))

    def _state_copy(self):
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def train(self):
        epochs = int(self.args.get("epochs", 10))
        patience = int(self.args.get("early_stop_patience", 50))
        seed = int(self.args.get("seed", 1234))
        best = (min(self.records["val_losses"])
                if self.records["val_losses"] else float("inf"))
        wait = self._wait
        train = self.splits["train"]
        for ep in range(self._start_epoch, epochs + 1):
            t0 = time.perf_counter()
            order = np.random.RandomState(seed + ep).permutation(len(train))
            losses = []          # (chunk loss, its real pairs)
            for lo in range(0, len(order), self.B):
                chunk = [train[i] for i in order[lo:lo + self.B]]
                lv = self.train_step(self._item(chunk, train=True))
                losses.append((lv, len(chunk)))
            vals = torch.stack([lv for lv, _ in losses]).tolist()
            dt = time.perf_counter() - t0
            self.epochs_trained += 1
            if os.environ.get("GLAM_TRAIN_STATS", "0") == "1":
                # pairs/s through the loop (its losses' read synchronized)
                self.log(f"\ttrain stats: {len(order)} pairs in "
                         f"{dt:.2f}s = {len(order) / max(dt, 1e-9):.2f}"
                         " pairs/s")
            n_tr = sum(n for _, n in losses)
            trn_loss = sum(v * n for v, (_, n) in zip(vals, losses)) \
                / max(n_tr, 1)
            val_loss, val_m = self.valid_iterations("valid")
            self.records["val_losses"].append(val_loss)
            self.records["trn_losses"].append(trn_loss)
            lr = get_learning_rate(self.optimizer)
            new_lr = self.scheduler.step(val_loss, lr)
            if new_lr != lr:
                set_learning_rate(self.optimizer, new_lr)
            self.log(f"Epoch:{ep} trn_loss:{trn_loss:.4f} "
                     f"val_loss:{val_loss:.4f} val_result:{val_m} "
                     f"lr_cur:{new_lr:.7f}")
            if val_loss < best:
                best, wait = val_loss, 0
                self._best_state = self._state_copy()
                self.save_ckpt(ep)
            else:
                wait += 1
            self.save_resume_ckpt(ep, wait)
            if wait >= patience:
                self.log(f"early stop at epoch {ep}")
                break
        self.model.load_state_dict(self._best_state)
        self.save_ckpt(epochs, final_save=True)

    def valid_iterations(self, mode: str = "valid"):
        split = self.splits["test" if mode == "test"
                            and self.splits["test"] else "valid"]
        ys, outs, losses = [], [], []
        for lo in range(0, len(split), self.B):
            chunk = split[lo:lo + self.B]
            item = self._item(chunk)
            logits, per = self.evaluate(item)
            n = len(chunk)
            ys.extend(item[2][:n].tolist())
            outs.append(logits[:n].cpu().numpy())
            losses.extend(per[:n].tolist())
        out = np.concatenate(outs)
        yt = np.asarray(ys)
        mean_loss = float(np.mean(losses))
        if self.task == "pair_regression":
            return mean_loss, regression_metrics(yt, out[:, 0])
        if self.task == "pair_binary_bce":
            return mean_loss, binary_metrics(
                yt, 1.0 / (1.0 + np.exp(-out[:, 0])))
        ex = np.exp(out - out.max(-1, keepdims=True))
        score = (ex / ex.sum(-1, keepdims=True))[:, 1]
        metric_fn = (screening_metrics if self.task == "pair_screening"
                     else binary_metrics)
        return mean_loss, metric_fn(yt, score, out.argmax(-1))

    def train_and_test(self):
        self.train()
        self.log("Testing...")
        val_loss, val_result = self.valid_iterations("valid")
        test_loss, test_result = self.valid_iterations("test")
        loss_info = {"testloss": float(test_loss),
                     "valloss": float(val_loss)}
        val_new = {"val" + k: v for k, v in val_result.items()}
        # the AutoML summary reads the config on the second-to-last line
        # and the {loss}|{test}|{val} result on the last
        self.log(str(self.args))
        self.log(f"{loss_info}|{test_result}|{val_new}")
        by_rank = [None] * self.n_shards
        graphs = {"step_graphs": self.step_graphs is not None,
                  "reason": self.step_graphs_reason,
                  "stats": (dict(self.step_graphs.stats)
                            if self.step_graphs else None)}
        torch.distributed.all_gather_object(
            by_rank, {"launches": launch_counts(), "steps": self.steps,
                      "forwards": self.forwards, "graphs": graphs,
                      "digest": state_digest(self.model, self.optimizer)})
        if self.is_main:
            record = {
                "run_id": self.run_id, "loss": loss_info,
                "test": test_result, "val": val_new,
                "config": {k: v for k, v in self.args.items()
                           if k != "model_cfg"},
                "epochs_trained": self.epochs_trained,
                "optimizer_steps": self.steps, "forwards": self.forwards,
                "seconds": time.time() - self.start,
                "kernel_launches": launch_counts(),
                "kernel_launches_by_rank": [r["launches"] for r in by_rank],
                "forwards_by_rank": [r["forwards"] for r in by_rank],
                "step_graphs": self.step_graphs is not None,
                "step_graphs_reason": self.step_graphs_reason,
                "step_graph_stats": graphs["stats"],
                "step_graphs_by_rank": [r["graphs"] for r in by_rank],
                # each rank's weights, statistics and optimizer state at
                # the end (optim.state_digest): equal where the bits are
                "state_digest_by_rank": [r["digest"] for r in by_rank]}
            with open(self.log_save_dir / "result.json", "w") as f:
                json.dump(record, f, indent=1)
        return loss_info, test_result, val_new

    # ------------------------------------------------------------------
    def save_ckpt(self, epoch: int, final_save: bool = False):
        """The dense PairArchitecture's checkpoint (``best_save.pt`` /
        ``final_save.pt``), which ``PairPredictor`` serves."""
        if not self.is_main:
            return
        save_checkpoint(self.log_save_dir, self.model, self.args,
                        which="final_save.pt" if final_save
                        else "best_save.pt", records=self.records)
        self.log(f"Model saved at epoch {epoch}")

    def save_resume_ckpt(self, epoch: int, wait: int):
        """``last_save.pt``: weights, the best epoch's weights, optimizer,
        scheduler, both noise generators, early-stop count and epoch (the
        shuffle derives from seed + epoch)."""
        if not self.is_main:
            return
        torch.save({
            "args": json.dumps(self.args),
            "records": json.dumps(self.records),
            "state_dict": {k: v.cpu() for k, v in self._state_copy().items()},
            "best_state": {k: v.cpu() for k, v in self._best_state.items()},
            "optimizer": self.optimizer.state_dict(),
            "scheduler": json.dumps(self.scheduler.state_dict()),
            "generator": self.generator.get_state(),
            "pro_generator": self.pro_generator.get_state(),
            "epoch": epoch, "wait": wait}, self.log_save_dir / "last_save.pt")

    def resume(self, run_dir) -> int:
        """Restore from ``<run_dir>/last_save.pt`` and continue in that
        run directory; returns the next epoch."""
        path = Path(run_dir)
        if path.is_dir():
            path = path / "last_save.pt"
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved_args = json.loads(payload["args"])
        # halo compares the flag: ring and a2a agree to rounding only
        defaults = {"halo": "a2a", "pair_batch": 1}
        for k in ("dataset", "seed", "model_cfg", "optim", "task",
                  "pro_shards", "halo", "pair_batch"):
            saved = saved_args.get(k, defaults.get(k))
            cur = self.args.get(k, defaults.get(k))
            if saved is not None and cur is not None and saved != cur:
                raise ValueError(f"resume mismatch on {k!r}")
        self.records = json.loads(payload["records"])
        self.scheduler.load_state_dict(json.loads(payload["scheduler"]))
        self.model.load_state_dict(payload["state_dict"])
        self._best_state = {k: v.to(self.device)
                            for k, v in payload["best_state"].items()}
        load_optimizer_state(self.optimizer, payload["optimizer"])
        self.generator.set_state(payload["generator"])
        self.pro_generator.set_state(payload["pro_generator"])
        self._wait = int(payload["wait"])
        self._start_epoch = int(payload["epoch"]) + 1
        fresh = self.log_save_dir
        self.log_save_dir = path.parent
        self.run_id = self.log_save_dir.name
        if self.is_main and fresh != self.log_save_dir:
            shutil.rmtree(fresh, ignore_errors=True)
        self.log(f"resumed from epoch {payload['epoch']}")
        return self._start_epoch

    def log(self, msg=None):
        if not self.is_main:
            return
        line = "" if msg is None else str(msg)
        print(line, flush=True)
        with open(self.log_save_dir / "log.txt", "a") as f:
            f.write(line + "\n")
