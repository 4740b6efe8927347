"""Evaluation metrics with numpy and scipy only: the single-graph
trainer's metrics of the JAX package's ``train/metrics.py``, which uses
scikit-learn.

ROC AUC is the Mann-Whitney statistic from average ranks
(``scipy.stats.rankdata``), so tied scores count one half, as
scikit-learn's trapezoidal ROC area counts them.  Precision and recall
are those of the positive class, 0 where undefined (``zero_division=0``);
R2 is 1 - SS_res / SS_tot, and 1.0 or 0.0 for a constant target, as
scikit-learn's ``r2_score`` gives.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.stats import rankdata

from ..data.datasets import is_regression


def auto_metrics(dataset: str) -> List[str]:
    if is_regression(dataset):
        return ["valr2", "r2"]
    return ["valauc", "auc"]


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels (both classes present)."""
    y = np.asarray(y_true).reshape(-1) == 1
    ranks = rankdata(np.asarray(y_score, np.float64).reshape(-1))
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("ROC AUC needs both classes in y_true")
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _precision_recall(y_true, y_pred):
    t = np.asarray(y_true).reshape(-1) == 1
    p = np.asarray(y_pred).reshape(-1) == 1
    tp = float((t & p).sum())
    prec = tp / p.sum() if p.sum() else 0.0
    rec = tp / t.sum() if t.sum() else 0.0
    return prec, rec


def binary_metrics_multi_target_nan(y_true, y_score, y_pred=None,
                                    threshold=0.5) -> Dict:
    """Per task over its labelled rows (label >= 0): auc, acc, precision
    and recall, averaged over the tasks that have both classes."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    if y_true.ndim == 1:
        y_true = y_true[:, None]
        y_score = y_score[:, None]
    if y_pred is None:
        y_pred = (y_score >= threshold).astype(int)
    rocs, accs, precs, recs = [], [], [], []
    for t in range(y_true.shape[1]):
        col = y_true[:, t]
        if (col == 1).sum() == 0 or (col == 0).sum() == 0:
            continue  # AUC undefined without both classes
        valid = col >= 0
        yt, ys, yp = col[valid], y_score[valid, t], y_pred[valid, t]
        rocs.append(roc_auc(yt, ys))
        accs.append(float(np.mean(yt == yp)))
        prec, rec = _precision_recall(yt, yp)
        precs.append(prec)
        recs.append(rec)
    if not rocs:
        return {"auc": float("nan"), "acc": float("nan"),
                "precision": float("nan"), "recall": float("nan")}
    return {"auc": float(np.mean(rocs)), "acc": float(np.mean(accs)),
            "precision": float(np.mean(precs)),
            "recall": float(np.mean(recs))}


def concordance_index(y_true, y_pred) -> float:
    """CI = P(pred ordering agrees | y_i != y_j), ties in pred count 0.5."""
    y = np.asarray(y_true, np.float64)
    f = np.asarray(y_pred, np.float64)
    dy = y[:, None] > y[None, :]
    df = f[:, None] - f[None, :]
    z = dy.sum()
    if z == 0:
        return float("nan")
    s = (dy * ((df > 0) + 0.5 * (df == 0))).sum()
    return float(s / z)


def regression_metrics(y_true, y_pred) -> Dict:
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, np.float64).reshape(-1)
    mse = float(np.mean((y_true - y_pred) ** 2))
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        r2 = 1.0 if ss_res == 0.0 else 0.0
    else:
        r2 = 1.0 - ss_res / ss_tot
    return {"ci": concordance_index(y_true, y_pred), "mse": mse,
            "rmse": mse ** 0.5, "r2": r2}
