"""Pair-task datasets: drug-drug interaction (DDI) and drug-target
interaction / virtual screening (DTI), the port of the JAX package's
``data/pair_datasets.py``.

  DDIDataset       interaction CSV (Drug1_SMILES, Drug2_SMILES, label),
                   read with the ``csv`` module, + a molecule store keyed
                   by :func:`molecule_key`; 70/10/20 random split
  BindingDBDataset fixed train/dev/test.txt files of space-separated
                   ``smiles sequence label`` plus a per-sequence contact
                   map store; proteins without contact maps are skipped
  LITPCBADataset   per-target active/inactive .smi files and the target's
                   sequence and contact map; 70/30 train/val, the val set
                   doubling as test, balanced class weights

The CSV cells that pandas' ``read_csv`` reads as NaN by default (the
empty cell, ``NA``, ``nan``, ...) are NaN here too: a SMILES cell of them
becomes the string ``'nan'``, as ``str(NaN)`` makes it there.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chem.proteins import load_contactmap, protein_to_arrays
from ..chem.scaffold import molecule_key
from ..chem.smiles import exotic_stereo_counts
from .datasets import featurize_smiles
from .graph import GraphArrays

# pandas.read_csv's default NaN spellings
_CSV_NAN = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])


def mol_graph(smi: str, y=0.0) -> Optional[GraphArrays]:
    """The molecular graph of ``smi`` with label ``y``; None where it
    cannot be featurized."""
    try:
        x, snd, rcv, e = featurize_smiles(smi)
    except ValueError:
        return None
    return GraphArrays(nodes=x, edges=e, senders=snd, receivers=rcv,
                       y=np.atleast_1d(np.asarray(y, np.float32)), smi=smi)


def _read_pair_csv(path: Path) -> List[Tuple[str, str, float]]:
    """(Drug1_SMILES, Drug2_SMILES, label) rows, NaN cells as pandas
    reads them."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))

    def smiles(cell):
        return "nan" if cell is None or cell in _CSV_NAN else cell

    def label(cell):
        return float("nan") if cell is None or cell in _CSV_NAN \
            else float(cell)

    return [(smiles(r["Drug1_SMILES"]), smiles(r["Drug2_SMILES"]),
             label(r["label"])) for r in rows]


class DDIDataset:
    """Drug-drug interaction pairs."""

    def __init__(self, root: str, dataset: str = "drugbank_caster",
                 split: str = "random", split_seed: int = 1234,
                 num_classes: Optional[int] = None):
        self.root = Path(root)
        self.dataset = dataset
        path = self.root / "raw" / dataset / "ddi_total.csv"
        if not path.exists():
            path = self.root / "raw" / f"{dataset}.csv"
        self.mol_store: Dict[str, GraphArrays] = {}
        # unresolvable exotic stereo tags (@SP/@TB/@OH, symmetric @AL)
        # merge spellings into one store key: count the unique store
        # molecules affected, not raw parse events
        self._exotic_keys: set = set()
        pairs: List[Tuple[str, str, float]] = []
        for s1, s2, y in _read_pair_csv(path):
            k1 = self._featurize(s1)
            k2 = self._featurize(s2)
            if k1 is None or k2 is None:
                continue
            pairs.append((k1, k2, float(y)))
        self.pairs = pairs
        self.n_exotic_stereo_dropped = len(self._exotic_keys)
        if self.n_exotic_stereo_dropped:
            print(f"[{dataset}] {self.n_exotic_stereo_dropped} store "
                  "molecule(s) carry exotic stereo tags with no "
                  "canonical descriptor (@SP/@TB/@OH or unresolvable "
                  "@AL): those stereoisomer identities merged")
        self.num_tasks = 1
        labels = {p[2] for p in pairs}
        if num_classes is not None:
            self.num_classes = num_classes
        elif labels <= {0.0, 1.0}:
            self.num_classes = 1  # binary sigmoid head
        else:
            # multiclass: class ids are the label values (may be
            # non-contiguous), so the head spans 0..max inclusive
            self.num_classes = int(max(labels)) + 1
        some = next(iter(self.mol_store.values()))
        self.num_node_features = int(some.nodes.shape[1])
        self.num_edge_features = int(some.edges.shape[1])
        rng = np.random.RandomState(split_seed)
        perm = rng.permutation(len(pairs))
        n_tr = int(0.7 * len(pairs))
        n_va = int(0.1 * len(pairs))
        self.train = self._make(perm[:n_tr])
        self.val = self._make(perm[n_tr:n_tr + n_va])
        self.test = self._make(perm[n_tr + n_va:])

    def _featurize(self, smi: str) -> Optional[str]:
        """Featurize once per canonical molecule; returns its store
        key."""
        before = sum(exotic_stereo_counts().values())
        key = molecule_key(smi)
        if not key:
            return None
        if sum(exotic_stereo_counts().values()) > before:
            self._exotic_keys.add(key)
        if key not in self.mol_store:
            g = mol_graph(smi)
            if g is None:
                return None
            self.mol_store[key] = g
        return key

    def _make(self, idx) -> List[Tuple[GraphArrays, GraphArrays]]:
        out = []
        for i in idx:
            s1, s2, y = self.pairs[i]
            g1 = self.mol_store[s1]._replace(
                y=np.asarray([y], np.float32))
            out.append((g1, self.mol_store[s2]))
        return out


def protein_graph(seq: str, contact_map: np.ndarray) -> GraphArrays:
    """The residue graph of a sequence and its contact map."""
    nodes, snd, rcv, attr = protein_to_arrays(seq, contact_map)
    return GraphArrays(nodes=nodes, edges=attr, senders=snd, receivers=rcv,
                       y=np.zeros(1, np.float32), smi=seq)


class BindingDBDataset:
    """DTI with protein contact-map graphs from fixed split files."""

    def __init__(self, root: str, dataset: str = "bindingdb_c",
                 contact_maps: Optional[Dict[str, np.ndarray]] = None):
        self.root = Path(root)
        self.dataset = dataset
        self.pro_store: Dict[str, GraphArrays] = {}
        self.mol_store: Dict[str, GraphArrays] = {}
        self.contact_maps = (contact_maps if contact_maps is not None
                             else load_contact_store(
                                 self.root / "raw" / dataset
                                 / "protein_maps.npz"))
        self.skipped_proteins = 0
        splits = {}
        for name in ("train", "dev", "test"):
            path = self.root / "raw" / dataset / f"{name}.txt"
            splits[name] = self._load_split(path)
        self.train = splits["train"]
        self.val = splits["dev"]
        self.test = splits["test"]
        self.num_tasks = 1
        if self.mol_store:
            some = next(iter(self.mol_store.values()))
            self.num_node_features = int(some.nodes.shape[1])
            self.num_edge_features = int(some.edges.shape[1])
        if self.pro_store:
            somep = next(iter(self.pro_store.values()))
            self.pro_num_node_features = int(somep.nodes.shape[1])
            self.pro_num_edge_features = int(somep.edges.shape[1])

    def _protein(self, seq: str) -> Optional[GraphArrays]:
        if seq in self.pro_store:
            return self.pro_store[seq]
        cm = self.contact_maps.get(seq)
        if cm is None:
            return None  # proteins without a contact map are skipped
        g = self.pro_store[seq] = protein_graph(seq, cm)
        return g

    def _load_split(self, path: Path
                    ) -> List[Tuple[GraphArrays, GraphArrays]]:
        out = []
        if not path.exists():
            return out
        for line in path.read_text().splitlines():
            parts = line.split()
            if len(parts) < 3:
                continue
            smi, seq, label = parts[0], parts[1], float(parts[2])
            if smi not in self.mol_store:
                g = mol_graph(smi)
                if g is None:
                    continue
                self.mol_store[smi] = g
            pro = self._protein(seq)
            if pro is None:
                self.skipped_proteins += 1
                continue
            mol = self.mol_store[smi]._replace(
                y=np.asarray([label], np.float32))
            out.append((mol, pro))
        return out


def load_contact_store(path: Path) -> Dict[str, np.ndarray]:
    """``protein_maps.npz``: {sequence -> dense contact matrix}; empty
    when the file is missing."""
    if not Path(path).exists():
        return {}
    z = np.load(path, allow_pickle=False)
    seqs = [str(s) for s in z["sequences"]]
    return {s: z[f"map_{i}"] for i, s in enumerate(seqs)}


LIT_PCBA_TARGETS = ("ALDH1", "ESR1_ant", "KAT2A", "MAPK1", "FEN1")


class LITPCBADataset:
    """LIT-PCBA virtual screening: per-target active/inactive .smi files.

    raw layout: raw/lit_pcba/{target}/{actives,inactives}.smi with
    ``smiles id`` lines, and {target}.seq holding the target FASTA, plus
    an optional {target}.contactmap.txt."""

    def __init__(self, root: str, target: str = "ALDH1",
                 split_seed: int = 1234):
        self.root = Path(root)
        self.target = target
        base = self.root / "raw" / "lit_pcba" / target
        actives = self._read_smi(base / "actives.smi", 1.0)
        inactives = self._read_smi(base / "inactives.smi", 0.0)
        seq = (base / f"{target}.seq").read_text().strip()
        cm_path = base / f"{target}.contactmap.txt"
        if cm_path.exists():
            cm, parsed_seq, _ = load_contactmap(cm_path)
            seq = parsed_seq or seq
        else:
            cm = np.zeros((len(seq), len(seq)), np.float32)
        self.protein = protein_graph(seq, cm)
        mols = actives + inactives
        rng = np.random.RandomState(split_seed)
        perm = rng.permutation(len(mols))
        n_tr = int(0.7 * len(mols))
        trn_idx, val_idx = perm[:n_tr], perm[n_tr:]
        self.train = [(mols[i], self.protein) for i in trn_idx]
        self.val = [(mols[i], self.protein) for i in val_idx]
        self.test = list(self.val)  # the V set doubles as test
        self.num_tasks = 1
        ys = np.asarray([g.y[0] for g in mols])
        # balanced class weights: n / (n_classes * bincount)
        counts = np.bincount(ys.astype(int), minlength=2)
        self.class_weights = len(ys) / (2.0 * np.maximum(counts, 1))
        self.num_node_features = int(mols[0].nodes.shape[1])
        self.num_edge_features = int(mols[0].edges.shape[1])
        self.pro_num_node_features = int(self.protein.nodes.shape[1])
        self.pro_num_edge_features = int(self.protein.edges.shape[1])

    @staticmethod
    def _read_smi(path: Path, label: float) -> List[GraphArrays]:
        out = []
        if not path.exists():
            return out
        for line in path.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            g = mol_graph(parts[0], label)
            if g is not None:
                out.append(g)
        return out
