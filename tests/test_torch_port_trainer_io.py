"""``Trainer.write_datasets`` and ``Trainer.gen_test_batch`` against the
JAX trainer's, on the CPU: the split CSVs byte for byte (the port writes
them with the ``csv`` module where JAX uses pandas; a DTI split's
``smiles,partner,label``), and the saved batch's arrays equal to the
JAX batch's (integer indices as int64 where JAX keeps int32)."""
import shutil
from pathlib import Path

import numpy as np
import pytest

from glam_tpu.data import datasets as jax_datasets
from glam_tpu.train import pair_trainer as jax_pair_trainer
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.train import pair_trainer as port_pair_trainer

DATA = Path(__file__).resolve().parents[1] / "datasets"
ARGS = {"e_dim": 16, "hid_dim_alpha": 1, "message_steps": 1, "epochs": 1,
        "mol_block": "_TripletMessage", "seed": 3, "batch_size": 16,
        "split": "random", "split_seed": 1234}


def _trainers(tmp_path, dataset, src, n=None, **extra):
    out = []
    for side, auto, make in (
            ("jax", jax_datasets.auto_dataset,
             jax_pair_trainer.make_auto_trainer),
            ("port", port_datasets.auto_dataset,
             port_pair_trainer.make_auto_trainer)):
        root = tmp_path / side / "data"
        shutil.copytree(DATA / src / "raw", root / "raw")
        if n:
            csv_path = root / "raw" / "demo.csv"
            lines = csv_path.read_text().splitlines()[:n + 1]
            csv_path.write_text("\n".join(lines) + "\n")
        args = dict(ARGS, dataset=dataset, dataset_root=str(root), **extra)
        args, ds, kind = auto(args)
        kw = {"device": "cpu"} if side == "port" else {}
        out.append(make(args, ds, kind, work_dir=str(tmp_path / side), **kw))
    return out


@pytest.mark.parametrize("dataset, src, n, extra", [
    ("demo", "demo", 80, {"loss": "bcel"}),
    ("bindingdb_c", "dti_demo", None, {"pro_block": "_GATConv"})],
    ids=["demo", "dti"])
def test_write_datasets_matches_jax(tmp_path, dataset, src, n, extra):
    tj, tp = _trainers(tmp_path, dataset, src, n, **extra)
    tj.write_datasets(str(tmp_path / "j"))
    tp.write_datasets(str(tmp_path / "p"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert "test.csv" in names
    for name in names:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    header = (tmp_path / "p" / "train.csv").read_text().splitlines()[0]
    assert header == ("smiles,label" if dataset == "demo"
                      else "smiles,partner,label")


def test_gen_test_batch_matches_jax(tmp_path):
    tj, tp = _trainers(tmp_path, "demo", "demo", 80, loss="bcel")
    jpath = tj.gen_test_batch(str(tmp_path / "j" / "b.npz"))
    ppath = tp.gen_test_batch(str(tmp_path / "p" / "b.npz"))
    want, got = np.load(jpath), np.load(ppath)
    assert {"nodes", "edges", "senders", "receivers", "node_graph",
            "node_mask", "graph_mask", "y", "csr_rowptr"} <= set(got.files)
    for k in ("nodes", "edges", "y"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("senders", "receivers", "node_graph", "n_node", "node_mask",
              "edge_mask", "graph_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
