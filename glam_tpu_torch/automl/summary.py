"""Run-log aggregation: parse per-run logs, summarize, rank configs; the
port of the JAX package's ``automl/summary.py`` without pandas.

A run's ``log.txt`` ends with its config (a dict repr) and the line
``{loss_info}|{test}|{val}``; both are read with ``ast.literal_eval``.
Unfinished runs (no final '{' line) and runs with inf metrics are
skipped, the reference's tolerance of crashed trials.  Rows are dicts;
``summarize_logs`` groups them by ``note`` (the config id) and gives
each numeric column's ``mean``, ``std`` (ddof 1, NaN for a group of
one), ``min`` and ``max``, as pandas' ``groupby(...).agg`` does, over
the values a group has (NaN where it has none).  Columns keep their
first appearance's order; the CSVs (``logs_summary.csv``,
``search_result.csv``, ``inf_ckpt_selected.csv``) have pandas'
columns, an empty cell for NaN.  Ranking sorts by the dataset's
selection metric (``auto_metrics(dataset)[0]``, else ``valacc``),
highest first, NaN last, and stably: tied values keep their order
(group key order, or the order runs were read in), where pandas'
quicksort may order them otherwise (ROADMAP §C).
"""
from __future__ import annotations

import ast
import csv
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..train.metrics import auto_metrics

_NAN = float("nan")


def read_logs(logs_dir: Path) -> List[Dict]:
    logs = []
    for log_file in sorted(Path(logs_dir).glob("*seed*/log.txt")):
        try:
            lines = log_file.read_text().strip().split("\n")
        except OSError:
            continue
        if len(lines) < 2 or not lines[-1].startswith("{"):
            continue  # unfinished/crashed run: skip silently
        try:
            config = ast.literal_eval(lines[-2])
            loss_info, test_res, val_res = (
                ast.literal_eval(p) for p in lines[-1].split("|"))
        except (ValueError, SyntaxError):
            continue
        row = {"id": log_file.parent.name, "config": str(config)}
        merged = {**loss_info, **test_res, **val_res}
        if any(isinstance(v, float) and not math.isfinite(v)
               for v in merged.values()):
            continue  # skip inf results (reference logger.py:76)
        row.update(merged)
        for k in ("dataset", "note", "seed", "epochs", "batch_size",
                  "mol_block", "optim", "lr"):
            if k in config:
                row[k] = config[k]
        logs.append(row)
    return logs


def _columns(rows: Sequence[Dict]) -> List[str]:
    """Every key of ``rows``, in order of first appearance."""
    return list(dict.fromkeys(k for r in rows for k in r))


def _is_nan(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _numeric_columns(rows: Sequence[Dict]) -> Dict[str, bool]:
    """{column: whether it holds ints} for each column whose values are
    all numbers: an int column (pandas' int64) has an int in every row,
    so its min and max stay ints."""
    out = {}
    for c in _columns(rows):
        vals = [r[c] for r in rows if c in r and not _is_nan(r[c])]
        if all(_is_number(v) for v in vals):
            out[c] = len(vals) == len(rows) and all(
                isinstance(v, int) for v in vals)
    return out


def _aggregate(vals: List, ints: bool) -> List:
    """[mean, std (ddof 1), min, max] of ``vals``, NaN where undefined."""
    if not vals:
        return [_NAN] * 4
    n = len(vals)
    mean = math.fsum(vals) / n
    std = (math.sqrt(math.fsum((v - mean) ** 2 for v in vals) / (n - 1))
           if n > 1 else _NAN)
    lo, hi = min(vals), max(vals)
    return [mean, std, lo if ints else float(lo), hi if ints else float(hi)]


def _rank(rows: List[Dict], key: str) -> List[int]:
    """Indices of ``rows`` by ``key``, highest first, rows without a value
    last; stable."""
    def order(i):
        v = rows[i].get(key)
        return (1, 0.0) if _is_nan(v) else (0, -v)
    return sorted(range(len(rows)), key=order)


def _cell(v):
    return "" if _is_nan(v) else v


def write_csv(path: Path, rows: Sequence[Dict], columns: Sequence[str],
              index: Optional[Sequence] = None) -> None:
    """``rows`` under ``columns`` (a missing or NaN cell empty), with a
    leading unnamed index column when ``index`` is given, as pandas'
    ``to_csv`` writes them."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index is not None else []) + list(columns))
        for i, r in enumerate(rows):
            w.writerow(([index[i]] if index is not None else [])
                       + [_cell(r.get(c)) for c in columns])


def summarize_logs(logs: List[Dict], dataset: str,
                   logs_dir: Optional[Path] = None) -> List[Dict]:
    """Group runs by config note/id, aggregate the numeric columns, rank
    by the dataset's selection metric's mean; optionally write the
    summary CSVs.  Returns the ranked groups' rows."""
    if not logs:
        return []
    metric = auto_metrics(dataset)[0]
    columns = _columns(logs)
    # group by the config id ('note'): each seed-run's config string
    # embeds its own seed, so grouping by 'config' would make one-row
    # groups and rank individual seed-runs instead of seed-averaged
    # configs (reference logger.py:103-118 groups by note)
    group_key = "note" if "note" in columns else "config"
    numeric = {c: ints for c, ints in _numeric_columns(logs).items()
               if c != group_key}
    groups: Dict = {}
    for r in logs:
        if not _is_nan(r.get(group_key)):
            groups.setdefault(r[group_key], []).append(r)
    agg = []
    for key in sorted(groups):
        rows = groups[key]
        out = {group_key: key}
        for c, ints in numeric.items():
            vals = [r[c] for r in rows if c in r and not _is_nan(r[c])]
            out.update(zip((f"{c}_{s}" for s in ("mean", "std", "min",
                                                 "max")),
                           _aggregate(vals, ints)))
        if group_key != "config":
            # one representative config string per group, for relaunching
            out["config"] = next((r["config"] for r in rows
                                  if not _is_nan(r.get("config"))), _NAN)
        agg.append(out)
    if f"{metric}_mean" in agg[0]:
        agg = [agg[i] for i in _rank(agg, f"{metric}_mean")]
    if logs_dir is not None:
        write_csv(Path(logs_dir) / "logs_summary.csv", agg, list(agg[0]))
        write_csv(Path(logs_dir) / "search_result.csv", logs, columns)
    return agg


def auto_summarize_logs(dataset: str, work_dir: Path = Path(".")
                        ) -> List[Dict]:
    logs_dir = Path(work_dir) / f"log_{dataset}"
    return summarize_logs(read_logs(logs_dir), dataset, logs_dir)


def print_ongoing_info(logs_dir: Path, tail: int = 2) -> List[str]:
    """Tail the last lines of every unfinished run (reference
    logger.py:10-20 print_ongoing_info)."""
    lines_out = []
    for log_file in sorted(Path(logs_dir).glob("*seed*/log.txt")):
        try:
            lines = log_file.read_text().strip().split("\n")
        except OSError:
            continue
        if lines and lines[-1].startswith("{"):
            continue  # finished
        for ln in lines[-tail:]:
            lines_out.append(f"{log_file.parent.name}: {ln}")
    for ln in lines_out:
        print(ln)
    return lines_out


def select_top_runs(logs_dir: Path, dataset: str, n: int) -> List[Dict]:
    """Top-n individual runs by val metric (reference
    GLAMHelper.select_top_config, trainer.py:399-414), written to
    ``inf_ckpt_selected.csv`` with their row numbers in the read order."""
    logs = read_logs(logs_dir)
    if not logs:
        return []
    columns = _columns(logs)
    metric = auto_metrics(dataset)[0]
    if metric not in columns:
        # e.g. multiclass DDI logs carry no valauc; rank by accuracy
        if "valacc" not in columns:
            return []
        metric = "valacc"
    order = _rank(logs, metric)[:min(n, len(logs))]
    sel = [logs[i] for i in order]
    write_csv(Path(logs_dir) / "inf_ckpt_selected.csv", sel, columns,
              index=order)
    return sel
