"""PASP perturbation dataset and robustness-evaluation data, the port of
the JAX package's ``data/perturb.py``:

  * ``PerturbationDataset``: the physprop CSV (``physprop_perturb.csv``:
    two unnamed columns, Label, SMILES, LogP, SMILES_{1,2,3},
    LogP_{1,2,3}, Similrity_{1,2,3}) split by its ``Label`` column
    (train/val/test) instead of random/scaffold;
  * ``perturb_test(root, dataset, level)``: the paired test sets M (the
    original test molecules) and M' (their perturbed variants at
    similarity level 1, 2 or 3), with label arrays Q (LogP) and Q'
    (LogP_level), over the test rows whose SMILES_level is not empty.

The CSV is read with ``datasets.read_csv``: an empty cell stands where
pandas reads NaN.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from .datasets import MolDataset, featurize_smiles, read_csv
from .graph import GraphArrays


def _featurize_list(smiles: List[str], labels: List[float]
                    ) -> List[GraphArrays]:
    out = []
    for smi, y in zip(smiles, labels):
        x, snd, rcv, e = featurize_smiles(smi)
        out.append(GraphArrays(nodes=x, edges=e, senders=snd, receivers=rcv,
                               y=np.asarray([y], np.float32), smi=smi))
    return out


def _raw_csv(root: str, dataset: str):
    return read_csv(Path(root) / "raw" / f"{dataset}.csv")[1]


class PerturbationDataset(MolDataset):
    """physprop_perturb with Label-column splits."""

    def __init__(self, root: str, dataset: str = "physprop_perturb",
                 split: str = "label", split_seed: int = 1234):
        self._label_cols = _raw_csv(root, dataset)
        super().__init__(root, dataset=dataset, split="label",
                         split_seed=split_seed, smiles_col="SMILES")

    def _load_or_split(self):
        # align Label rows with the (possibly skip-filtered) graph list by
        # SMILES string; a SMILES listed twice takes its last row's label
        cols = self._label_cols
        label_by_smi = dict(zip(cols["SMILES"], cols["Label"]))
        tr, va, te = [], [], []
        for i, g in enumerate(self.graphs):
            lab = label_by_smi.get(g.smi, "train")
            (tr if lab == "train" else va if lab == "val" else te).append(i)
        return (np.asarray(tr, np.int64), np.asarray(va, np.int64),
                np.asarray(te, np.int64))


def perturb_test(root: str, dataset: str = "physprop_perturb",
                 level: int = 1) -> Tuple[List[GraphArrays],
                                          List[GraphArrays],
                                          np.ndarray, np.ndarray]:
    """(M, M', Q, Q') for a perturbation level."""
    col = {1: "SMILES_1", 2: "SMILES_2", 3: "SMILES_3"}[level]
    cols = _raw_csv(root, dataset)
    rows = [i for i, (lab, smi) in enumerate(zip(cols["Label"], cols[col]))
            if lab == "test" and smi != ""]
    original = [cols["SMILES"][i] for i in rows]
    perturbed = [cols[col][i] for i in rows]
    Q = np.asarray([float(cols["LogP"][i]) for i in rows], np.float64)
    Q_prime = np.asarray([float(cols[f"LogP_{level}"][i]) for i in rows],
                         np.float64)
    M = _featurize_list(original, Q.tolist())
    M_prime = _featurize_list(perturbed, Q.tolist())
    return M, M_prime, Q, Q_prime
