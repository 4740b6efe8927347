"""Build a PASP perturbation benchmark from a plain property CSV: the
port of the JAX package's ``data/perturb_builder.py``, without pandas.

The pipeline is the JAX builder's (reference
``src_perturbed_dataset/perturb-real_point.ipynb``, cells 9-30):

  1. fingerprint every molecule (``chem/fingerprints.py``); for each,
     the first candidate among the others at each similarity level
     (level 1 [0.8, 1.0), 2 [0.5, 0.8), 3 [0.3, 0.5)) with
     |dLogP| < ``thre``;
  2. keep the molecules with a candidate at all three levels;
  3. draw the test rows (~1/6 of the corpus) from them by scaffold
     split; scaffold-split the molecules no test row names 75/25 into
     train and val;
  4. write the reference schema: Label, SMILES, LogP, then
     SMILES_k/LogP_k/Similrity_k for k = 1, 2, 3 on test rows (the
     reference's 'Similrity' spelling is kept: the loaders read it).

The table is the ``{column: cells}`` mapping that
``data.datasets.read_csv`` returns, and the output a list of row dicts
over ``COLUMNS``; the CSV has the JAX builder's columns and rows, an
empty cell where pandas writes NaN.

    python -m glam_tpu_torch.data.perturb_builder physprop.csv \\
        physprop_perturb.csv --smiles_col SMILES --value_col LogP
"""
from __future__ import annotations

import csv
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..chem.fingerprints import fingerprint_matrix, tanimoto_row
from ..chem.scaffold import random_scaffold_split
from .datasets import _floats, read_csv

LEVEL_BUCKETS = {1: (0.8, 1.0), 2: (0.5, 0.8), 3: (0.3, 0.5)}
COLUMNS = ["Label", "SMILES", "LogP",
           "SMILES_1", "LogP_1", "Similrity_1",
           "SMILES_2", "LogP_2", "Similrity_2",
           "SMILES_3", "LogP_3", "Similrity_3"]


def find_perturb_candidates(smiles, values, thre: float = 0.2,
                            radius: int = 2, n_bits: int = 2048
                            ) -> Dict[int, Dict[int, tuple]]:
    """For each molecule i: {level: (j, similarity)} of the first
    candidate j per level (in corpus order), restricted to
    |values[j] - values[i]| < thre; only molecules with a candidate at
    every level appear."""
    smiles = [str(s) for s in smiles]
    values = np.asarray(values, np.float64)
    fps = fingerprint_matrix(smiles, radius, n_bits)
    popcounts = np.bitwise_count(fps).sum(axis=1)
    out: Dict[int, Dict[int, tuple]] = {}
    for i in range(len(smiles)):
        sim = tanimoto_row(fps, i, popcounts)
        ok_val = np.abs(values - values[i]) < thre
        ok_val[i] = False
        ok_val &= popcounts > 0  # unparseable rows never qualify
        found: Dict[int, tuple] = {}
        for level, (lo, hi) in LEVEL_BUCKETS.items():
            mask = ok_val & (sim >= lo) & (sim < hi)
            j = int(np.argmax(mask))
            if mask[j]:
                found[level] = (j, float(sim[j]))
        if len(found) == len(LEVEL_BUCKETS):
            out[i] = found
    return out


def build_perturbed_dataset(table: Mapping[str, Sequence[str]],
                            out_csv: Optional[str] = None,
                            smiles_col: str = "SMILES",
                            value_col: str = "LogP", thre: float = 0.2,
                            seed: int = 0, test_frac: float = 1.0 / 6.0,
                            radius: int = 2, n_bits: int = 2048
                            ) -> List[Dict]:
    """Run the pipeline on ``table`` ({column: cells}); returns the rows
    (dicts over ``COLUMNS``, missing keys empty) and writes them to
    ``out_csv`` when given, loadable by ``data.perturb``."""
    smiles = [s if s.strip() else "nan" for s in table[smiles_col]]
    values = _floats(table[value_col])
    cands = find_perturb_candidates(smiles, values, thre, radius, n_bits)
    eligible = sorted(cands)
    if not eligible:
        raise ValueError("no molecule has perturbation candidates at all "
                         "three similarity levels; corpus too small or "
                         "too diverse")
    n_test = int(len(smiles) * test_frac)
    test_rate = min(n_test / len(eligible), 1.0)
    _, _, te = random_scaffold_split(
        [smiles[i] for i in eligible], seed=seed,
        frac_train=1.0 - test_rate, frac_valid=0.0)

    rows: List[Dict] = []
    excluded = set()
    for i in (eligible[k] for k in te):
        row = {"Label": "test", "SMILES": smiles[i], "LogP": values[i]}
        excluded.add(smiles[i])
        for level in (1, 2, 3):
            j, sim = cands[i][level]
            row[f"SMILES_{level}"] = smiles[j]
            row[f"LogP_{level}"] = values[j]
            row[f"Similrity_{level}"] = sim
            excluded.add(smiles[j])
        rows.append(row)

    # train/val pool: every molecule no test row names
    pool = [i for i in range(len(smiles)) if smiles[i] not in excluded]
    tr, va, _ = random_scaffold_split([smiles[i] for i in pool],
                                      seed=seed, frac_train=0.75,
                                      frac_valid=0.25)
    for label, ks in (("train", tr), ("val", va)):
        rows += [{"Label": label, "SMILES": smiles[pool[k]],
                  "LogP": values[pool[k]]} for k in ks]
    if out_csv:
        write_rows(out_csv, rows)
    return rows


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def write_rows(path, rows: Sequence[Mapping]) -> None:
    """``rows`` as a CSV over ``COLUMNS``, floats as pandas writes them
    (shortest round-trip form), NaN and missing keys as empty cells."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        for row in rows:
            writer.writerow([_cell(row.get(c, "")) for c in COLUMNS])


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Build a PASP perturbation benchmark CSV from a "
                    "property CSV (reference perturb-real_point.ipynb)")
    p.add_argument("in_csv")
    p.add_argument("out_csv")
    p.add_argument("--smiles_col", default="SMILES")
    p.add_argument("--value_col", default="LogP")
    p.add_argument("--thre", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    _, table = read_csv(a.in_csv)
    rows = build_perturbed_dataset(table, a.out_csv, a.smiles_col,
                                   a.value_col, a.thre, a.seed)
    counts: Dict[str, int] = {}
    for r in rows:
        counts[r["Label"]] = counts.get(r["Label"], 0) + 1
    print(f"wrote {a.out_csv}: {counts}")


if __name__ == "__main__":
    main()
