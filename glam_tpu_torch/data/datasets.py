"""Property-prediction datasets: CSV -> featurized graph lists with
caching, the single-graph part of the JAX package's ``data/datasets.py``.

The CSV is read with the ``csv`` module: an empty cell is NaN, and a NaN
label of a classification dataset becomes -1 (``datasets.py:136-137``).
The processed cache (``processed/dataset_<name>.npz``) and the split
indices (``processed/split_<seed>_<name>_<split>.npz``) have the JAX
package's names and contents, so either package reads what the other
wrote.  Both are written atomically (a temporary file in the same
directory, then ``os.replace``), so trials started together on a fresh
root never read a half-written file; a cache that does not load (one
left truncated by an older writer) is rebuilt.  ``auto_dataset`` routes
the pair datasets to ``data/pair_datasets.py`` and ``physprop_perturb``
to ``data/perturb.py``.
"""
from __future__ import annotations

import csv
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.native import smiles_to_arrays_native
from ..chem.scaffold import random_scaffold_split
from .graph import GraphArrays


def featurize_smiles(smi: str):
    """SMILES -> (x, senders, receivers, edge_attr) through the C++
    featurizer, byte-identical to ``chem.featurize.smiles_to_arrays``
    (the JAX package's ``datasets.py:28-33`` without its Python
    fallback: a featurizer that cannot be built raises)."""
    return smiles_to_arrays_native(smi)


DATASET_NAMES = {
    "r": ["esol", "freesolv", "lipophilicity", "physprop_perturb"],
    "c": ["demo", "bbbp", "bace", "sider", "toxcast", "tox21", "clintox",
          "hiv", "muv"],
}

PAIR_DATASET_NAMES = {
    "ddi": ["drugbank_caster"],
    "dti": ["bindingdb_c"],
    "scr": ["ALDH1", "ESR1_ant", "KAT2A", "MAPK1", "FEN1"],
}

TASKS: Dict[str, List[str]] = {
    "demo": ["label"],
    "muv": ["MUV-466", "MUV-548", "MUV-600", "MUV-644", "MUV-652",
            "MUV-689", "MUV-692", "MUV-712", "MUV-713", "MUV-733",
            "MUV-737", "MUV-810", "MUV-832", "MUV-846", "MUV-852",
            "MUV-858", "MUV-859"],
    "tox21": ["NR-AR", "NR-AR-LBD", "NR-AhR", "NR-Aromatase", "NR-ER",
              "NR-ER-LBD", "NR-PPAR-gamma", "SR-ARE", "SR-ATAD5", "SR-HSE",
              "SR-MMP", "SR-p53"],
    "sider": [f"SIDER{i}" for i in range(1, 28)],
    "clintox": ["FDA_APPROVED", "CT_TOX"],
    "bbbp": ["BBBP"],
    "bace": ["Class"],
    "esol": ["measured log solubility in mols per litre"],
    "freesolv": ["expt"],
    "lipophilicity": ["exp"],
    "hiv": ["HIV_active"],
    "physprop_perturb": ["LogP"],
}


def read_csv(path) -> Tuple[List[str], Dict[str, List[str]]]:
    """(header, {column: cells}) of a CSV file, cells as strings; an
    empty column name i is ``Unnamed: i``, as pandas names it."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = [h or f"Unnamed: {i}" for i, h in enumerate(next(reader))]
        cols: Dict[str, List[str]] = {h: [] for h in header}
        for row in reader:
            for h, cell in zip(header, row):
                cols[h].append(cell)
            for h in header[len(row):]:
                cols[h].append("")
    return header, cols


def _floats(cells: Sequence[str]) -> np.ndarray:
    return np.asarray([float(c) if c.strip() else np.nan for c in cells],
                      np.float64)


def dataset_tasks(dataset: str, header: Optional[List[str]] = None
                  ) -> List[str]:
    if dataset == "toxcast":
        if header is None:
            raise ValueError("toxcast tasks come from the CSV header")
        return [c for c in header if c.lower() != "smiles"]
    return TASKS[dataset]


def is_regression(dataset: str) -> bool:
    return dataset in DATASET_NAMES["r"]


class MolDataset:
    """Featurized molecular property dataset with train/val/test splits."""

    def __init__(self, root: str, dataset: str = "bbbp",
                 split: str = "random", split_seed: int = 1234,
                 smiles_col: str = "smiles"):
        self.root = Path(root)
        self.dataset = dataset
        self.split_type = split
        self.split_seed = split_seed
        self.processed_dir = self.root / "processed"
        self.processed_dir.mkdir(parents=True, exist_ok=True)
        raw = self.root / "raw" / f"{dataset}.csv"
        if not raw.exists():
            raise FileNotFoundError(f"raw dataset csv not found: {raw}")
        header, cols = read_csv(raw)
        self.tasks = dataset_tasks(dataset, header)
        self.num_tasks = len(self.tasks)
        self.graphs = self._load_or_process(cols, smiles_col)
        self.num_node_features = int(self.graphs[0].nodes.shape[1])
        self.num_edge_features = int(self.graphs[0].edges.shape[1])
        tr, va, te = self._load_or_split()
        self.train = [self.graphs[i] for i in tr]
        self.val = [self.graphs[i] for i in va]
        self.test = [self.graphs[i] for i in te]

    def _cache_path(self) -> Path:
        return self.processed_dir / f"dataset_{self.dataset}.npz"

    def _load_or_process(self, cols: Dict[str, List[str]],
                         smiles_col: str) -> List[GraphArrays]:
        cache = self._cache_path()
        if cache.exists():
            try:
                return load_graph_cache(cache)
            except (zipfile.BadZipFile, EOFError, ValueError, KeyError,
                    OSError) as err:
                print(f"[{self.dataset}] rebuilding {cache.name}: it does "
                      f"not load ({type(err).__name__}: {err})")
        if smiles_col not in cols:
            # the physprop file uses 'SMILES'
            for alt in ("SMILES", "Smiles"):
                if alt in cols:
                    smiles_col = alt
                    break
        target = np.stack([_floats(cols[t]) for t in self.tasks], axis=1)
        graphs: List[GraphArrays] = []
        n_skipped = 0
        for i, smi in enumerate(cols[smiles_col]):
            try:
                x, snd, rcv, e = featurize_smiles(smi)
            except ValueError:  # SmilesError/FeaturizeError subclass it
                n_skipped += 1
                continue
            label = target[i].copy()
            if not is_regression(self.dataset):
                label[np.isnan(label)] = -1
            graphs.append(GraphArrays(
                nodes=x, edges=e, senders=snd, receivers=rcv,
                y=label.astype(np.float32), smi=smi))
        if n_skipped:
            print(f"[{self.dataset}] skipped {n_skipped} unparseable SMILES")
        save_graph_cache(cache, graphs)
        return graphs

    def _load_or_split(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        p = (self.processed_dir /
             f"split_{self.split_seed}_{self.dataset}_{self.split_type}.npz")
        if p.exists():
            try:
                with np.load(p) as z:
                    return z["train"], z["val"], z["test"]
            except (zipfile.BadZipFile, EOFError, ValueError, KeyError,
                    OSError) as err:
                print(f"[{self.dataset}] redrawing {p.name}: it does not "
                      f"load ({type(err).__name__}: {err})")
        n = len(self.graphs)
        rng = np.random.RandomState(self.split_seed)
        perm = rng.permutation(n)
        if self.split_type == "random":
            n_tr, n_va = int(0.8 * n), int(0.1 * n)
            tr = perm[:n_tr]
            va = perm[n_tr:n_tr + n_va]
            te = perm[n_tr + n_va:]
        elif self.split_type == "scaffold":
            smis = [self.graphs[i].smi for i in perm]
            t0, v0, s0 = random_scaffold_split(smis, seed=self.split_seed)
            tr, va, te = perm[t0], perm[v0], perm[s0]
        else:
            raise ValueError(f"Unknown split type {self.split_type!r}")
        save_npz_atomic(p, np.savez, train=tr, val=va, test=te)
        return tr, va, te


def save_npz_atomic(path: Path, save=np.savez, **arrays) -> None:
    """``save(file, **arrays)`` (``np.savez`` or ``np.savez_compressed``)
    into a temporary ``.npz`` beside ``path``, then ``os.replace`` onto
    it: a reader finds no file or a whole one, never a half-written one.
    The temporary file is removed if the save fails."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.stem}.",
                               suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            save(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def save_graph_cache(path: Path, graphs: Sequence[GraphArrays]) -> None:
    """Pack a graph list into one npz (ragged via concat + offsets),
    written atomically (:func:`save_npz_atomic`)."""
    nodes = np.concatenate([g.nodes for g in graphs], 0)
    edges = np.concatenate([g.edges for g in graphs], 0)
    senders = np.concatenate([g.senders for g in graphs])
    receivers = np.concatenate([g.receivers for g in graphs])
    n_off = np.cumsum([0] + [g.nodes.shape[0] for g in graphs])
    e_off = np.cumsum([0] + [g.senders.shape[0] for g in graphs])
    ys = np.stack([g.y for g in graphs])
    smis = np.asarray([g.smi for g in graphs])
    save_npz_atomic(path, np.savez_compressed, nodes=nodes, edges=edges,
                    senders=senders, receivers=receivers, n_off=n_off,
                    e_off=e_off, y=ys, smi=smis)


def load_graph_cache(path: Path) -> List[GraphArrays]:
    # read each array once: indexing the NpzFile decompresses it anew
    with np.load(path, allow_pickle=False) as z:
        nodes, edges = z["nodes"], z["edges"]
        senders, receivers = z["senders"], z["receivers"]
        n_off, e_off, ys, smis = z["n_off"], z["e_off"], z["y"], z["smi"]
    out = []
    for i in range(len(n_off) - 1):
        ns, ne = n_off[i], n_off[i + 1]
        es, ee = e_off[i], e_off[i + 1]
        out.append(GraphArrays(
            nodes=nodes[ns:ne], edges=edges[es:ee],
            senders=senders[es:ee], receivers=receivers[es:ee],
            y=ys[i], smi=str(smis[i])))
    return out


def auto_dataset(args: dict):
    """(args, dataset, trainer kind), as the JAX package's
    ``auto_dataset`` resolves them; sets ``args['out_dim']`` from the loss
    and the task count, and for the pair datasets their default loss when
    ``args['loss']`` is unset or ``mse`` (the CLI's default): DDI
    ``bcel``, BindingDB ``ce``, LIT-PCBA ``wce``."""
    name = args["dataset"]
    pairs = [n for v in PAIR_DATASET_NAMES.values() for n in v]
    if name not in DATASET_NAMES["r"] + DATASET_NAMES["c"] + pairs:
        raise ValueError("error dataset input")
    split_seed = args.get("split_seed", 1234)
    default_loss = args.get("loss") in (None, "mse")
    if name in PAIR_DATASET_NAMES["ddi"]:
        # binary vs multiclass head: decided by the dataset's label set
        from .pair_datasets import DDIDataset
        ds = DDIDataset(args["dataset_root"], dataset=name,
                        split_seed=split_seed)
        if default_loss:
            args["loss"] = "bcel"
        return args, ds, "pair_ddi"
    if name in PAIR_DATASET_NAMES["dti"]:
        from .pair_datasets import BindingDBDataset
        ds = BindingDBDataset(args["dataset_root"], dataset=name)
        args["out_dim"] = 2
        if default_loss:
            args["loss"] = "ce"
        return args, ds, "pair_binary"
    if name in PAIR_DATASET_NAMES["scr"]:
        from .pair_datasets import LITPCBADataset
        ds = LITPCBADataset(args["dataset_root"], target=name,
                            split_seed=split_seed)
        args["out_dim"] = 2
        if default_loss:
            args["loss"] = "wce"
        return args, ds, "pair_screening"
    if name == "physprop_perturb":
        # Label-column splits (the JAX package's PerturbationDataset)
        from .perturb import PerturbationDataset
        ds = PerturbationDataset(args["dataset_root"], dataset=name,
                                 split_seed=split_seed)
    else:
        ds = MolDataset(args["dataset_root"], dataset=name,
                        split=args.get("split", "random"),
                        split_seed=split_seed)
    loss = args.get("loss", "mse")
    if name in DATASET_NAMES["c"]:
        if loss in ("ce", "mtce"):
            trainer = "binary_nan"
            args["out_dim"] = 2 * ds.num_tasks
        elif loss in ("bce", "bcel"):
            trainer = "binary_nan_bce"
            args["out_dim"] = 1 * ds.num_tasks
        else:
            raise ValueError("error loss input")
    else:
        trainer = "regression"
        args["out_dim"] = 1 * ds.num_tasks
    return args, ds, trainer
