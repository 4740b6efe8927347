"""Evaluation metrics with numpy and scipy only: the metrics of the JAX
package's ``train/metrics.py``, which uses scikit-learn.

ROC AUC is the Mann-Whitney statistic from average ranks
(``scipy.stats.rankdata``), so tied scores count one half, as
scikit-learn's trapezoidal ROC area counts them; with one class in
y_true ``binary_metrics`` and ``screening_metrics`` give NaN, as
``roc_auc_score`` does.  Precision and recall are those of the positive
class, 0 where undefined (``zero_division=0``), except in
``binary_metrics`` and ``multi_class_metrics``: there they are macro
means over the labels in y_true or y_pred, as scikit-learn's
``average="macro"`` takes them.  PR AUC is the trapezoidal area under
scikit-learn's ``precision_recall_curve``: a point per distinct score,
highest first, then (recall 0, precision 1).  R2 is 1 - SS_res / SS_tot,
and 1.0 or 0.0 for a constant target, as scikit-learn's ``r2_score``
gives.  The screening metrics' tie orders are those of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data.datasets import is_regression


def auto_metrics(dataset: str) -> List[str]:
    if is_regression(dataset):
        return ["valr2", "r2"]
    return ["valauc", "auc"]


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve of binary labels (both classes present)."""
    y = np.asarray(y_true).reshape(-1) == 1
    # imported here: scipy.stats takes seconds to import, which every
    # trainer process (each rank, each AutoML trial) paid at start-up
    from scipy.stats import rankdata
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
    prec = tp / float(p.sum()) if p.sum() else 0.0
    rec = tp / float(t.sum()) if t.sum() else 0.0
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


def _roc_auc_or_nan(y_true, y_score) -> float:
    y = np.asarray(y_true).reshape(-1)
    if np.unique(y).size != 2:
        return float("nan")
    return roc_auc(y, y_score)


def _trapezoid(y, x) -> float:
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


def pr_auc(y_true, y_score) -> float:
    """Area under the precision-recall curve of scikit-learn's
    ``precision_recall_curve``: precision and recall at each distinct
    score (a threshold), highest score first; recall 1 everywhere when
    y_true has no positive; the point (recall 0, precision 1) last."""
    y = (np.asarray(y_true).reshape(-1) == 1).astype(np.float64)
    s = np.asarray(y_score, np.float64).reshape(-1)
    order = np.argsort(-s, kind="stable")
    s, y = s[order], y[order]
    thr = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[thr]
    fps = 1 + thr - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] else np.ones_like(tps)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return -_trapezoid(precision, recall)


def _macro_prf(y_true, y_pred):
    """Macro precision, recall and F1 over the labels in y_true or y_pred
    (each 0 where undefined)."""
    t = np.asarray(y_true).reshape(-1)
    p = np.asarray(y_pred).reshape(-1)
    precs, recs, f1s = [], [], []
    for c in np.union1d(t, p):
        tp = float(((t == c) & (p == c)).sum())
        n_pred, n_true = float((p == c).sum()), float((t == c).sum())
        precs.append(tp / n_pred if n_pred else 0.0)
        recs.append(tp / n_true if n_true else 0.0)
        f1s.append(2 * tp / (n_pred + n_true) if n_pred + n_true else 0.0)
    return float(np.mean(precs)), float(np.mean(recs)), float(np.mean(f1s))


def binary_metrics(y_true, y_score, y_pred=None, threshold=0.5) -> Dict:
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if y_pred is None:
        y_pred = (y_score >= threshold).astype(int)
    prec, rec, f1 = _macro_prf(y_true, y_pred)
    return {"auc": _roc_auc_or_nan(y_true, y_score),
            "prauc": pr_auc(y_true, y_score),
            "acc": float(np.mean(y_true == np.asarray(y_pred).reshape(-1))),
            "precision": prec, "recall": rec, "f1": f1}


def bedroc_score(y_true, y_score, decreasing=True, alpha=20.0) -> float:
    """Boltzmann-enhanced discrimination of ROC (Truchon & Bayly 2007,
    eq. 36): the RIE (exponentially rank-weighted hit sum over its
    uniform-ranking expectation) mapped onto [0, 1] with the saturation
    bounds."""
    labels = np.asarray(y_true).reshape(-1)
    scores = np.asarray(y_score).reshape(-1)
    total = labels.size
    # tie behavior is parity-load-bearing: argsort of the negated
    # scores keeps ascending input order within tied scores
    ranking = np.argsort(-scores if decreasing else scores)
    hit_ranks = 1 + np.flatnonzero(labels[ranking] == 1)
    ratio = hit_ranks.size / total
    weighted = np.exp(-alpha * hit_ranks / total).sum()
    expected = (ratio * (1 - np.exp(-alpha))
                / (np.exp(alpha / total) - 1))
    rie = weighted / expected
    half = alpha / 2.0
    onto_01 = ratio * np.sinh(half) / (np.cosh(half)
                                       - np.cosh(half - alpha * ratio))
    lower = 1.0 / (1 - np.exp(alpha * (1 - ratio)))
    return float(rie * onto_01 + lower)


def enrichment_factor_single(y_true, y_score, threshold=0.005) -> float:
    """EF@threshold: fraction of all actives recovered in the top
    ``threshold`` slice of the ranked list, over the random baseline
    (NaN labels propagate through nansum)."""
    labels = np.asarray(y_true).reshape(-1)
    scores = np.asarray(y_score).reshape(-1)
    valid = labels != -1
    labels, scores = labels[valid], scores[valid]
    top = int(labels.size * threshold)
    # parity tie behavior: ascending argsort reversed (not argsort of
    # the negation): tied scores pick the later input rows first
    picked = np.argsort(scores)[::-1][:top]
    total_actives = np.nansum(labels)
    if total_actives <= 0:
        raise ValueError("n actives == 0")
    return float(np.nansum(labels[picked]) / total_actives / threshold)


def screening_metrics(y_true, y_score, y_pred=None, threshold=0.5) -> Dict:
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if y_pred is None:
        y_pred = (y_score > threshold).astype(int)
    prec, rec = _precision_recall(y_true, y_pred)
    d = {
        "auc": _roc_auc_or_nan(y_true, y_score),
        "acc": float(np.mean(y_true == np.asarray(y_pred).reshape(-1))),
        "precision": prec,
        "recall": rec,
        "bedroc": bedroc_score(y_true, y_score),
    }
    for name, thr in [("ef_001", 0.001), ("ef_005", 0.005), ("ef_01", 0.01),
                      ("ef_02", 0.02), ("ef_05", 0.05)]:
        d[name] = enrichment_factor_single(y_true, y_score, thr)
    return d


def multi_class_metrics(y_true, y_score, y_pred=None) -> Dict:
    """DDI multi-class metrics: accuracy and macro P/R/F1."""
    y_true = np.asarray(y_true).reshape(-1)
    if y_pred is None:
        y_pred = np.argmax(np.asarray(y_score), axis=-1)
    prec, rec, f1 = _macro_prf(y_true, y_pred)
    return {"acc": float(np.mean(y_true == np.asarray(y_pred).reshape(-1))),
            "precision": prec, "recall": rec, "f1": f1}


# ----------------------- ensemble blending ------------------------------

def blend_regression(outputs, opt="mean", return_pred=False):
    """outputs: list of (y_true, y_pred) arrays; blend = mean of preds."""
    ys = [np.asarray(o[0]) for o in outputs]
    ps = [np.asarray(o[1]) for o in outputs]
    blended = np.mean(np.stack(ps, axis=1), axis=1)
    if return_pred:
        return blended
    return regression_metrics(ys[0], blended)


def blend_binary_classification_mt(outputs,
                                   metrics_fn=binary_metrics_multi_target_nan):
    """outputs: list of (y_score, y_true); blend = mean of scores."""
    ss = [np.asarray(o[0]) for o in outputs]
    ls = [np.asarray(o[1]) for o in outputs]
    blended = np.mean(np.stack(ss, axis=-1), axis=-1)
    return metrics_fn(ls[0], blended)


def blend_binary_classification(outputs, opt="vote",
                                metrics_fn=binary_metrics):
    """outputs: list of (y_true, y_pred_label, y_score); the mean score and
    a majority vote of the labels, whose ties go to the smallest label
    (as torch's ``mode``)."""
    ls = [np.asarray(o[0]) for o in outputs]
    pls = [np.asarray(o[1]) for o in outputs]
    ss = [np.asarray(o[2]) for o in outputs]
    stack = np.stack(pls, axis=1)
    vote = np.apply_along_axis(
        lambda r: np.bincount(r.astype(int)).argmax(), 1, stack)
    mean_score = np.mean(np.stack(ss, axis=1), axis=1)
    return metrics_fn(ls[0], y_score=mean_score, y_pred=vote)
