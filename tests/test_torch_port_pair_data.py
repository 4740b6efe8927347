"""The pair families' data path of the port against the JAX package, on
the CPU, all exact: residue features, protein graphs and the contact-map
parser; ``molecule_key`` on every SMILES of ``ddi_demo`` and on
re-spellings; the DDI, BindingDB and LIT-PCBA datasets (store keys, pair
order, split membership, node and edge arrays, class weights, skipped
proteins); every shared field of ``PairGraphLoader``'s batches over two
shuffled epochs; and ``auto_dataset``'s routing of the pair names."""
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from glam_tpu.chem import proteins as jax_proteins
from glam_tpu.chem import scaffold as jax_scaffold
from glam_tpu.data import batching as jax_batching
from glam_tpu.data import datasets as jax_datasets
from glam_tpu.data import pair_datasets as jax_pairs
from glam_tpu_torch.chem import proteins as port_proteins
from glam_tpu_torch.chem import scaffold as port_scaffold
from glam_tpu_torch.data import batching as port_batching
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.data import pair_datasets as port_pairs

DATA = Path(__file__).resolve().parents[1] / "datasets"
DDI_CSV = DATA / "ddi_demo" / "raw" / "drugbank_caster.csv"
FIELDS = ("nodes", "edges", "senders", "receivers", "node_graph",
          "node_pos", "n_node", "node_mask", "edge_mask", "graph_mask", "y")


def _same_graph(a, b):
    for f in ("nodes", "edges", "senders", "receivers", "y"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape and np.array_equal(x, y), f
    assert a.smi == b.smi


def _same_pairs(got, want):
    assert len(got) == len(want)
    for (g1, g2), (w1, w2) in zip(got, want):
        _same_graph(g1, w1)
        _same_graph(g2, w2)


# --------------------------------------------------------------- proteins
def test_residue_features_and_tables():
    for r in port_proteins.RES_TYPES:
        assert port_proteins.residue_features(r) == \
            jax_proteins.residue_features(r), r
    for r in ("X", "U", "B"):        # unknown residues raise in both
        with pytest.raises(KeyError):
            jax_proteins.residue_features(r)
        with pytest.raises(KeyError):
            port_proteins.residue_features(r)
    assert port_proteins.NUM_PRO_NODE_FEATURES == 49


@pytest.mark.parametrize("seed", [0, 1])
def test_protein_graph(seed):
    rng = np.random.RandomState(seed)
    L = 40
    seq = "".join(rng.choice(list(port_proteins.RES_TYPES), L))
    cm = rng.rand(L, L).astype(np.float32)
    cm = np.where(cm > 0.7, cm, 0.0)
    cm = np.maximum(cm, cm.T)
    # the bucket edges, the overlapping l4 bucket among them
    cm[0, 5] = cm[5, 0] = 0.5
    cm[1, 7] = cm[7, 1] = 0.9
    cm[2, 9] = 0.1
    got = port_proteins.protein_to_arrays(seq, cm)
    want = jax_proteins.protein_to_arrays(seq, cm)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_contact_map_parser(tmp_path):
    p = tmp_path / "x.contactmap.txt"
    p.write_text("PFRMAT RR\nTARGET T1\nSEQ ACDEF\nMODEL 1\n"
                 "1 4 0.85\n2 5 0.05\n3 5 0 8 0.4\nEND\n")
    for path in (p, DATA / "scr_demo" / "raw" / "lit_pcba" / "ALDH1"
                 / "ALDH1.contactmap.txt"):
        got = port_proteins.load_contactmap(path)
        want = jax_proteins.load_contactmap(path)
        assert got[1] == want[1] and got[2] == want[2]
        assert got[0].tobytes() == want[0].tobytes()
        assert port_proteins.read_probs(path) == \
            jax_proteins.read_probs(path)


# ------------------------------------------------------------ molecule key
def test_molecule_key_on_ddi_demo_and_respellings():
    df = pd.read_csv(DDI_CSV)
    smis = sorted(set(df.Drug1_SMILES) | set(df.Drug2_SMILES))
    assert len(smis) > 50
    for s in smis:
        assert port_scaffold.molecule_key(s) == jax_scaffold.molecule_key(s)
    respelled = [("OCC", "CCO"), ("c1ccccc1O", "Oc1ccccc1"),
                 ("N[C@@H](C)C(=O)O", "C[C@H](N)C(=O)O"),
                 ("F/C=C/F", "F\\C=C\\F"), ("F/C=C\\F", "F\\C=C/F"),
                 ("C[C@H](N)O", "C[C@@H](N)O"), ("xyz", "C1CC")]
    for a, b in respelled:
        ka = port_scaffold.molecule_key(a)
        assert ka == jax_scaffold.molecule_key(a)
        assert port_scaffold.molecule_key(b) == jax_scaffold.molecule_key(b)


# ---------------------------------------------------------------- datasets
def _ddi_root(tmp_path, text=None):
    root = tmp_path / "ddi"
    (root / "raw").mkdir(parents=True)
    if text is None:
        shutil.copy(DDI_CSV, root / "raw" / "drugbank_caster.csv")
    else:
        (root / "raw" / "drugbank_caster.csv").write_text(text)
    return root


def _same_ddi(root):
    got = port_pairs.DDIDataset(str(root))
    want = jax_pairs.DDIDataset(str(root))
    assert got.pairs == want.pairs
    assert list(got.mol_store) == list(want.mol_store)
    for k in want.mol_store:
        _same_graph(got.mol_store[k], want.mol_store[k])
    for split in ("train", "val", "test"):
        _same_pairs(getattr(got, split), getattr(want, split))
    assert got.num_classes == want.num_classes
    assert got.n_exotic_stereo_dropped == want.n_exotic_stereo_dropped
    return got


@pytest.fixture(scope="module")
def ddi_bundled(tmp_path_factory):
    return _same_ddi(_ddi_root(tmp_path_factory.mktemp("bundled")))


def test_ddi_dataset_bundled(ddi_bundled):
    assert len(ddi_bundled.pairs) == 500 and ddi_bundled.num_classes == 1


def test_ddi_dataset_unparseable_and_nan_cells(tmp_path):
    text = ("Drug1_SMILES,Drug2_SMILES,label\n"
            "CCO,c1ccccc1,1\nC1CC,CCO,0\nOCC,CCN,0\nxyz,CCC,1\n"
            "CCC,,1\nNA,CCO,0\nCC(C)C,C[C@H](N)O,1\nCCS,c1ccncc1,0\n"
            "Oc1ccccc1,c1ccccc1O,1\nCCOC,CCO,0\n")
    ds = _same_ddi(_ddi_root(tmp_path, text))
    assert len(ds.pairs) < 10


def test_bindingdb_dataset():
    root = str(DATA / "dti_demo")
    got = port_pairs.BindingDBDataset(root)
    want = jax_pairs.BindingDBDataset(root)
    for split in ("train", "val", "test"):
        _same_pairs(getattr(got, split), getattr(want, split))
    assert got.skipped_proteins == want.skipped_proteins
    assert list(got.pro_store) == list(want.pro_store)
    assert got.pro_num_node_features == want.pro_num_node_features == 49
    assert got.pro_num_edge_features == want.pro_num_edge_features == 8
    assert len(got.train) > 300 and got.skipped_proteins == 0
    # a store without one protein's contact map: its pairs are skipped
    cms = dict(got.contact_maps)
    cms.pop(next(iter(cms)))
    got = port_pairs.BindingDBDataset(root, contact_maps=cms)
    want = jax_pairs.BindingDBDataset(root, contact_maps=cms)
    assert got.skipped_proteins == want.skipped_proteins > 0
    _same_pairs(got.train, want.train)


def test_litpcba_dataset():
    root = str(DATA / "scr_demo")
    got = port_pairs.LITPCBADataset(root, "ALDH1")
    want = jax_pairs.LITPCBADataset(root, "ALDH1")
    for split in ("train", "val", "test"):
        _same_pairs(getattr(got, split), getattr(want, split))
    _same_graph(got.protein, want.protein)
    np.testing.assert_array_equal(got.class_weights, want.class_weights)
    assert port_pairs.LIT_PCBA_TARGETS == jax_pairs.LIT_PCBA_TARGETS


# ------------------------------------------------------------------ loader
@pytest.mark.parametrize("which", ["ddi", "dti"])
def test_pair_loader_batches_two_epochs(ddi_bundled, which):
    if which == "ddi":
        pairs = ddi_bundled.train[:90]
    else:
        pairs = jax_pairs.BindingDBDataset(str(DATA / "dti_demo")).train[:90]
    kw = dict(batch_size=16, num_tasks=1, shuffle=True, seed=7)
    got = port_batching.PairGraphLoader(pairs, **kw)
    want = jax_batching.PairGraphLoader(pairs, **kw)
    assert got.budget1 == want.budget1 and got.budget2 == want.budget2
    assert len(got) == len(want) == 6
    for _ in range(2):
        n = 0
        for (p1, p2), (j1, j2) in zip(got, want):
            for pb, jb in ((p1, j1), (p2, j2)):
                for f in FIELDS:
                    a, b = getattr(pb, f).numpy(), np.asarray(getattr(jb, f))
                    assert a.shape == b.shape and np.array_equal(a, b), f
            n += 1
        assert n == 6
    assert got.epoch == want.epoch == 2
    # serving's budget floors
    big = port_batching.PairGraphLoader(pairs[:3], 16, 1,
                                        budget1=(4096, 8), budget2=None)
    ref = jax_batching.PairGraphLoader(pairs[:3], 16, 1,
                                       budget1=(4096, 8), budget2=None)
    assert big.budget1 == ref.budget1 and big.budget2 == ref.budget2
    assert big.budget1[0] == 4096


@pytest.mark.parametrize("name,root,kind,out_dim,loss", [
    ("drugbank_caster", "ddi_demo", "pair_ddi", None, "bcel"),
    ("bindingdb_c", "dti_demo", "pair_binary", 2, "ce"),
    ("ALDH1", "scr_demo", "pair_screening", 2, "wce")])
def test_auto_dataset_routes_pairs(tmp_path, name, root, kind, out_dim,
                                   loss):
    if name == "drugbank_caster":        # 60 pairs route as 500 do
        lines = DDI_CSV.read_text().splitlines(keepends=True)[:61]
        root = _ddi_root(tmp_path, "".join(lines))
    for given in (None, "mse", "focal"):
        args = {"dataset": name, "dataset_root": str(DATA / root)}
        if given:
            args["loss"] = given
        got_args, ds, got_kind = port_datasets.auto_dataset(dict(args))
        want_args, _, want_kind = jax_datasets.auto_dataset(dict(args))
        assert got_kind == want_kind == kind
        assert got_args == want_args
        assert got_args["loss"] == (loss if given in (None, "mse")
                                    else given)
        assert got_args.get("out_dim") == out_dim
        assert type(ds).__name__ == type(_).__name__
