"""Ensemble blending: rebuild, reload, infer, combine; the port of the
JAX package's ``automl/ensemble.py``.

For each selected run id: rebuild the dataset, model and trainer from
the stored config on ``device``, point at the run's directory, load its
``best_save.pt``, run the test set (or ``custom_test``) in inference
mode, then blend:
  * regression: mean of predictions (src_1gp/metrics.py:153-186)
  * 1gp classification: mean of scores
  * DDI binary: mean of sigmoid scores (src_2gi_ddi/trainer.py:324-330)
  * DDI multiclass: mean of class probabilities, then argmax
  * DTI/screening: mean of scores + majority vote of predicted labels
    (src_2gi_dti_scr/trainer.py:397-406).
``pasp_ensemble`` holds the blend to PASP on ``physprop_perturb``.
"""
from __future__ import annotations

import ast
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..data.batching import GraphLoader, PairGraphLoader
from ..data.datasets import auto_dataset
from ..train.metrics import (binary_metrics,
                             binary_metrics_multi_target_nan,
                             blend_binary_classification,
                             blend_binary_classification_mt,
                             blend_regression, multi_class_metrics,
                             regression_metrics, screening_metrics)
from ..train.pair_trainer import PairTrainer, make_auto_trainer


def _rebuild_trainer(config: dict, work_dir: Path, custom_test=None,
                     device="cuda"):
    args = dict(config)
    args, dataset, kind = auto_dataset(args)
    trainer = make_auto_trainer(args, dataset, kind, work_dir=str(work_dir),
                                device=device)
    # the fresh trainer made a new (empty) run dir; remove it and point at
    # the checkpointed run instead (reference trainer.py:361,368)
    shutil.rmtree(trainer.log_save_dir, ignore_errors=True)
    trainer.print_log = False
    if custom_test is not None:
        loader = (PairGraphLoader if isinstance(trainer, PairTrainer)
                  else GraphLoader)
        trainer.test_loader = loader(custom_test, 32, dataset.num_tasks)
    return trainer, dataset


def blend_multi_class(outputs):
    """outputs: list of (y_true, y_pred, prob); mean-prob + argmax."""
    ls = [np.asarray(o[0]) for o in outputs]
    probs = [np.asarray(o[2]) for o in outputs]
    mean_prob = np.mean(np.stack(probs, 0), axis=0)
    return multi_class_metrics(ls[0], mean_prob)


def _blend_outputs(task: str, dataset_name: str, outputs,
                   return_pred: bool = False):
    """Route inference-output tuples to the family's blender."""
    if task in ("regression", "pair_regression"):
        if return_pred:
            return blend_regression(outputs, return_pred=True)
        return blend_regression(outputs)
    if task == "pair_binary_bce":        # DDI binary: (score, y)
        return blend_binary_classification_mt(
            outputs, metrics_fn=binary_metrics)
    if task == "pair_multiclass":        # DDI multiclass: (y, pred, prob)
        return blend_multi_class(outputs)
    if task in ("pair_binary", "pair_screening"):
        # DTI: (y, pred, score) -> mean-score + vote-of-labels
        metrics_fn = (screening_metrics if task == "pair_screening"
                      else binary_metrics)
        return blend_binary_classification(outputs, opt="vote",
                                           metrics_fn=metrics_fn)
    # 1gp classification: multi-task mean-of-scores
    return blend_binary_classification_mt(
        outputs, metrics_fn=binary_metrics_multi_target_nan)


def blend_and_inference(ids: List[str], configs: List, work_dir: Path,
                        custom_test=None, log: Callable = print,
                        return_pred: bool = False, device="cuda"):
    """Blend the runs ``ids`` (their configs, dict reprs or dicts) of
    ``work_dir``, each run's inference on ``device``; None without
    runs."""
    outputs = []
    dataset_name = None
    task = None
    for run_id, config_str in zip(ids, configs):
        config = (ast.literal_eval(config_str)
                  if isinstance(config_str, str) else dict(config_str))
        dataset_name = config["dataset"]
        trainer, _ = _rebuild_trainer(config, Path(work_dir), custom_test,
                                      device)
        trainer.log_save_dir = (Path(work_dir) / f"log_{dataset_name}"
                                / run_id)
        trainer.load_best_ckpt()
        log(f"Checkpoint {run_id} loaded.")
        out = trainer.valid_iterations(mode="inference")
        # normalize per-task inference tuples to what the blenders
        # expect: regression -> (y, pred); classification -> (score, y).
        # The binary_nan ('ce') trainer returns (y, score, pred).
        if trainer.task == "binary_nan":
            out = (out[1], out[0])
        task = trainer.task
        outputs.append(out)
        log("inference done!")
    if not outputs:
        return None
    return _blend_outputs(task, dataset_name, outputs,
                          return_pred=return_pred)


def pasp_ensemble(solver, log: Callable = print) -> Optional[Dict]:
    """PASP robustness of the blended ensemble (reference
    trainer.py:450-463): Delta_RMSE = rmse(P, P') - rmse(Q, Q') over the
    three perturbation levels, each run's inference on the solver's
    device.  Returns {level: Delta_RMSE}, None without checkpoints."""
    from ..data.perturb import perturb_test
    from .summary import select_top_runs

    sel = select_top_runs(solver.logs_dir, solver.dataset,
                          solver.n_top_blend)
    if not sel:
        log("PASP: no checkpoints")
        return None
    ids = [r["id"] for r in sel]
    configs = [r["config"] for r in sel]
    results = {}
    for level in (1, 2, 3):
        log(f"Run solution for perturbed test level {level}...")
        M, M_prime, Q, Q_prime = perturb_test(
            solver.dataset_root, solver.dataset, level)
        P = blend_and_inference(ids, configs, solver.work_dir,
                                custom_test=M, log=log, return_pred=True,
                                device=solver.device)
        P_prime = blend_and_inference(ids, configs, solver.work_dir,
                                      custom_test=M_prime, log=log,
                                      return_pred=True,
                                      device=solver.device)
        l_pp = regression_metrics(P, P_prime)
        l_qq = regression_metrics(Q, Q_prime)
        log(f"L(P, P') is {l_pp}, and\n L(Q, Q') is {l_qq}")
        results[level] = l_pp["rmse"] - l_qq["rmse"]
        log("Delta_RMSE={}".format(results[level]))
    return results
