"""Pair-task trainers (DDI / DTI / screening), the port of the JAX
package's ``train/pair_trainer.py``:

  pair_binary_bce   DDI: sigmoid + BCE on a single pair logit
  pair_multiclass   DDI: CE over C classes + softmax scores
  pair_regression   DTI: regression criterion on one output
  pair_binary       DTI: 2-logit softmax CE (or class-weighted ``wce``,
                    or ``focal``)
  pair_screening    LIT-PCBA: class-weighted CE by default + screening
                    metrics (BEDROC/EF)

``PairTrainer`` shares the ``Trainer`` skeleton (epoch loop, early stop,
scheduler, checkpoints, parseable final line; its steps are generic over
the (g1, g2) parts); only the loaders, the loss and the metric heads
differ.  Checkpoints carry ``model_cfg``, ``task``, ``out_dim`` and
``num_classes``, so ``serve.PairPredictor`` rebuilds the model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..data.batching import PairGraphLoader
from ..nn.model import PairArchitecture, model_config_from_args
from .losses import bce_logits, cross_entropy, get_loss
from .metrics import (binary_metrics, multi_class_metrics,
                      regression_metrics, screening_metrics)
from .trainer import Trainer, make_trainer, make_weight_fn


def make_pair_loss_fn(task: str, loss_name: str, class_weights=None,
                      device="cpu"):
    """``loss(outputs [G, D], y [G, 1], graph_mask) -> scalar`` on
    outputs on ``device`` (where the class weights are put).  The 2-logit
    tasks take ``ce``, ``wce`` or ``focal`` as asked, else their default
    (``wce`` for screening, ``ce`` otherwise).  Class
    targets of the padding slot (label -1) are taken as class 0: their
    weight is 0, so the loss does not change (the JAX package's gathers
    wrap the -1 to the last class instead)."""
    if task == "pair_binary_bce":
        def loss_fn(out, y, gmask):
            return bce_logits(out[:, 0], y[:, 0], weight=gmask.to(out.dtype))
    elif task == "pair_multiclass":
        def loss_fn(out, y, gmask):
            return cross_entropy(out, y[:, 0].clamp(min=0.0),
                                 weight=gmask.to(out.dtype))
    elif task == "pair_regression":
        criterion = get_loss(loss_name)

        def loss_fn(out, y, gmask):
            return criterion(out[:, 0], y[:, 0], weight=gmask.to(out.dtype))
    elif task in ("pair_binary", "pair_screening"):
        name = (loss_name if loss_name in ("ce", "wce", "focal")
                else ("wce" if task == "pair_screening" else "ce"))
        kw = {}
        if class_weights is not None and name == "wce":
            kw["class_weight"] = torch.as_tensor(
                np.asarray(class_weights), dtype=torch.float32,
                device=device)
        criterion = get_loss("focal") if name == "focal" else cross_entropy

        def loss_fn(out, y, gmask):
            return criterion(out, y[:, 0].clamp(min=0.0),
                             weight=gmask.to(out.dtype), **kw)
    else:
        raise ValueError(f"unknown pair task {task!r}")
    return loss_fn


class PairTrainer(Trainer):
    """Trainer over (GraphBatch, GraphBatch) pair streams."""

    def __init__(self, args: Dict, model: PairArchitecture, train_pairs,
                 valid_pairs, test_pairs=None, print_log: bool = True,
                 work_dir: Optional[str] = None, class_weights=None,
                 device="cuda"):
        self.class_weights = class_weights
        super().__init__(args, model, train_pairs, valid_pairs, test_pairs,
                         print_log=print_log, work_dir=work_dir,
                         device=device)

    def _make_loaders(self, train_pairs, valid_pairs, test_pairs):
        nt = self.num_tasks
        self.train_loader = PairGraphLoader(
            train_pairs, int(self.args.get("batch_size", 32)), nt,
            shuffle=True, seed=int(self.args.get("seed", 1234)),
            **self._split())
        self.valid_loader = self._eval_loader(valid_pairs)
        self.test_loader = (self._eval_loader(test_pairs)
                            if test_pairs else None)

    def _eval_loader(self, pairs):
        return PairGraphLoader(pairs, self.eval_batch, self.num_tasks,
                               **self._split())

    def _make_loss(self):
        return make_pair_loss_fn(self.task, self.args.get("loss", "bcel"),
                                 self.class_weights, self.device)

    def _make_weight(self):
        """A rank's loss weight (the JAX pair trainer's ``_make_weight``):
        for class-weighted ``wce``, the class weights of its real pairs'
        targets summed, else the count of real pairs."""
        loss_name = self.args.get("loss", "bcel")
        name = (loss_name if loss_name in ("ce", "wce", "focal")
                else ("wce" if self.task == "pair_screening" else "ce"))
        if self.task in ("pair_binary", "pair_screening") \
                and name == "wce" and self.class_weights is not None:
            cw = torch.as_tensor(np.asarray(self.class_weights),
                                 dtype=torch.float32, device=self.device)

            def weight_fn(y, gmask):
                tgt = y[:, 0].long().clamp(0, cw.shape[0] - 1)
                return (cw[tgt] * gmask.float()).sum()
            return weight_fn
        return make_weight_fn(self.task)

    def valid_iterations(self, mode: str = "valid"):
        out, y, mean_loss = self._gather(
            "valid" if mode == "valid" else
            ("test" if self.test_loader else "valid"))
        if mode != "inference" and not np.isfinite(out).all():
            # diverged parameters: report an inf-loss sentinel
            return float("inf"), {"diverged": 1.0}
        yt = y[:, 0]
        if self.task == "pair_regression":
            pred = out[:, 0]
            if mode == "inference":
                return yt, pred
            return mean_loss, regression_metrics(yt, pred)
        if self.task == "pair_binary_bce":
            score = 1.0 / (1.0 + np.exp(-out[:, 0]))
            if mode == "inference":
                return score, yt
            return mean_loss, binary_metrics(yt, score)
        ex = np.exp(out - out.max(-1, keepdims=True))
        prob = ex / ex.sum(-1, keepdims=True)
        pred = out.argmax(-1)
        if self.task == "pair_multiclass":
            if mode == "inference":
                return yt, pred, prob
            return mean_loss, multi_class_metrics(yt, prob, pred)
        # pair_binary / pair_screening: 2-logit softmax
        score = prob[:, 1]
        if mode == "inference":
            return yt, pred, score
        metric_fn = (screening_metrics if self.task == "pair_screening"
                     else binary_metrics)
        return mean_loss, metric_fn(yt, score, pred)


def _pair_trainer(args: Dict, dataset, hetero: bool,
                  overrides: Dict, work_dir, device,
                  class_weights=None) -> PairTrainer:
    overrides.setdefault("mol_in_dim", dataset.num_node_features)
    overrides.setdefault("mol_edge_in_dim", dataset.num_edge_features)
    overrides.setdefault("out_dim", args["out_dim"])
    _set_pair_max_nodes(overrides, dataset.train + dataset.val
                        + dataset.test, hetero=hetero)
    cfg = model_config_from_args(args, **overrides)
    args["model_cfg"] = dataclasses.asdict(cfg)  # self-describing ckpts
    model = PairArchitecture(cfg, hetero=hetero,
                             generator=torch.Generator().manual_seed(
                                 int(args.get("seed", 1234))))
    return PairTrainer(args, model, dataset.train, dataset.val, dataset.test,
                       work_dir=work_dir, class_weights=class_weights,
                       device=device)


def make_ddi_trainer(args: Dict, dataset, work_dir=None,
                     model_overrides: Optional[Dict] = None,
                     device="cuda") -> PairTrainer:
    """The homo pair model and its trainer for a ``DDIDataset``: a
    single-logit BCE head for binary labels, else a multiclass head."""
    args = dict(args)
    nc = getattr(dataset, "num_classes", 1)
    args["task"] = "pair_multiclass" if nc > 2 else "pair_binary_bce"
    args["num_classes"] = nc
    args["num_tasks"] = 1
    args["out_dim"] = nc if nc > 2 else 1
    return _pair_trainer(args, dataset, False, dict(model_overrides or {}),
                         work_dir, device)


def make_dti_trainer(args: Dict, dataset, task: str = "pair_binary",
                     work_dir=None, model_overrides: Optional[Dict] = None,
                     device="cuda") -> PairTrainer:
    """The hetero pair model and its trainer for a ``BindingDBDataset``
    or ``LITPCBADataset`` (whose class weights ``wce`` takes)."""
    args = dict(args)
    args["task"] = task
    args["num_tasks"] = 1
    args["out_dim"] = 1 if task == "pair_regression" else 2
    overrides = dict(model_overrides or {})
    overrides.setdefault("pro_in_dim", dataset.pro_num_node_features)
    overrides.setdefault("pro_edge_in_dim", dataset.pro_num_edge_features)
    return _pair_trainer(args, dataset, True, overrides, work_dir, device,
                         getattr(dataset, "class_weights", None))


def make_auto_trainer(args: Dict, dataset, kind: str, work_dir=None,
                      device="cuda") -> Trainer:
    """The trainer for a trainer kind from ``auto_dataset``: the single
    dispatch point of the run CLI over the three task families."""
    if kind == "pair_ddi":
        return make_ddi_trainer(args, dataset, work_dir=work_dir,
                                device=device)
    if kind in ("pair_binary", "pair_screening", "pair_regression"):
        return make_dti_trainer(args, dataset, task=kind, work_dir=work_dir,
                                device=device)
    return make_trainer(args, dataset, kind, work_dir=work_dir,
                        device=device)


def _set_pair_max_nodes(overrides: Dict, pairs, hetero: bool = False):
    m1 = max((p[0].nodes.shape[0] for p in pairs), default=1)
    m2 = max((p[1].nodes.shape[0] for p in pairs), default=1)
    overrides.setdefault("max_nodes", m1 if hetero else max(m1, m2))
    overrides.setdefault("pro_max_nodes" if hetero else "max_nodes",
                         m2 if hetero else max(m1, m2))
