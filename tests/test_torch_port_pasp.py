"""The port's PASP slice against the JAX package, on the CPU:
``PerturbationDataset`` (Label-column splits), ``perturb_test`` at the
three similarity levels, ``complete_graph``, ``auto_dataset``'s routing
of ``physprop_perturb``, and ``Trainer.pasp`` from the same weights.

The data come from a 300-row slice of the in-repo
``datasets/physprop/raw/physprop_perturb.csv`` (200 train, 50 val and
50 test rows, every test row with variants at levels 1-3), each package
on its own temporary copy.  Tolerances: graphs, splits, labels and
perturbation sets exact (the same featurizer and the same rows);
Delta_RMSE 1e-4 (float32 forwards through two frameworks, differenced).
"""
import ast
import csv
from pathlib import Path

import jax
import numpy as np
import pytest

from glam_tpu.data import datasets as jax_datasets
from glam_tpu.data import perturb as jax_perturb
from glam_tpu.data.transforms import complete_graph as jax_complete
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.data import perturb as port_perturb
from glam_tpu_torch.data.transforms import complete_graph as port_complete
from glam_tpu_torch.train import trainer as port_trainer

PHYSPROP = (Path(__file__).resolve().parents[1] / "datasets" / "physprop"
            / "raw" / "physprop_perturb.csv")


def _slice_rows():
    with open(PHYSPROP, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    by = {lab: [r for r in body if r[2] == lab]
          for lab in ("train", "val", "test")}
    return header, by["train"][:200] + by["val"][:50] + by["test"][:50]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two copies of the slice: (JAX root, port root)."""
    header, rows = _slice_rows()
    out = []
    for side in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"physprop_{side}")
        (root / "raw").mkdir()
        with open(root / "raw" / "physprop_perturb.csv", "w",
                  newline="") as f:
            csv.writer(f, lineterminator="\n").writerows([header] + rows)
        out.append(root)
    return tuple(out)


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in ("nodes", "edges", "senders", "receivers", "y"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
        assert ga.smi == gb.smi


def test_perturbation_dataset_matches_jax(roots):
    jroot, proot = roots
    want = jax_perturb.PerturbationDataset(str(jroot))
    got = port_perturb.PerturbationDataset(str(proot))
    assert (len(got.train), len(got.val), len(got.test)) == (200, 50, 50)
    for part in ("graphs", "train", "val", "test"):
        _same_graphs(getattr(got, part), getattr(want, part))
    assert got.tasks == want.tasks == ["LogP"]
    assert got.num_tasks == 1
    # auto_dataset routes it as the JAX package does: regression
    args = {"dataset": "physprop_perturb", "dataset_root": str(proot),
            "loss": "mse"}
    got_args, ds, kind = port_datasets.auto_dataset(dict(args))
    want_args, _, want_kind = jax_datasets.auto_dataset(
        dict(args, dataset_root=str(jroot)))
    assert isinstance(ds, port_perturb.PerturbationDataset)
    assert kind == want_kind == "regression"
    assert got_args["out_dim"] == want_args["out_dim"] == 1
    _same_graphs(ds.test, want.test)


def test_read_csv_names_the_unnamed_columns():
    header, cols = port_datasets.read_csv(PHYSPROP)
    assert header[:4] == ["Unnamed: 0", "Unnamed: 1", "Label", "SMILES"]
    assert len(cols["Unnamed: 0"]) == len(cols["SMILES"]) == 12607


@pytest.mark.parametrize("level", [1, 2, 3])
def test_perturb_test_matches_jax(roots, level):
    jroot, proot = roots
    M_j, Mp_j, Q_j, Qp_j = jax_perturb.perturb_test(str(jroot), level=level)
    M_p, Mp_p, Q_p, Qp_p = port_perturb.perturb_test(str(proot), level=level)
    assert len(M_p) == 50
    _same_graphs(M_p, M_j)
    _same_graphs(Mp_p, Mp_j)
    np.testing.assert_array_equal(Q_p, Q_j)
    np.testing.assert_array_equal(Qp_p, Qp_j)
    assert Q_p.dtype == Q_j.dtype and Qp_p.dtype == Qp_j.dtype


def test_perturb_test_skips_rows_without_a_variant(tmp_path):
    header, rows = _slice_rows()
    rows = [list(r) for r in rows]
    tests = [r for r in rows if r[2] == "test"]
    tests[0][header.index("SMILES_2")] = ""
    tests[1][header.index("SMILES_2")] = ""
    roots = []
    for side in ("jax", "port"):
        root = tmp_path / side
        (root / "raw").mkdir(parents=True)
        with open(root / "raw" / "physprop_perturb.csv", "w",
                  newline="") as f:
            csv.writer(f, lineterminator="\n").writerows([header] + rows)
        roots.append(root)
    want = jax_perturb.perturb_test(str(roots[0]), level=2)
    got = port_perturb.perturb_test(str(roots[1]), level=2)
    assert len(got[0]) == 48
    _same_graphs(got[0], want[0])
    _same_graphs(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])


def test_complete_graph_matches_jax(roots):
    M, Mp, _, _ = port_perturb.perturb_test(str(roots[1]), level=1)
    for g in M[:10] + Mp[:10]:
        got, want = port_complete(g), jax_complete(g)
        n = g.nodes.shape[0]
        assert got.senders.shape == (n * (n - 1),)
        for f in ("nodes", "edges", "senders", "receivers", "y"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype


ARGS = {"dataset": "physprop_perturb", "loss": "mse", "epochs": 1,
        "batch_size": 32, "e_dim": 32, "hid_dim_alpha": 2,
        "message_steps": 2, "seed": 5, "mol_block": "_TripletMessage",
        "mol_readout": "GlobalPool5", "graph_norm": "_PairNorm",
        "pre_act": "CELU", "graph_act": "CELU", "flat_act": "CELU",
        "pre_do": "_None()", "graph_do": "_None()", "flat_do": "_None()",
        "end_do": "_None()"}


def test_trainer_pasp_matches_jax(roots, tmp_path):
    """No training: the JAX trainer's initial weights carried to the
    port's; Delta_RMSE at levels 1-3 and the logged lines."""
    jroot, proot = roots
    args, ds, kind = jax_datasets.auto_dataset(
        dict(ARGS, dataset_root=str(jroot)))
    tj = jax_trainer.make_trainer(args, ds, kind,
                                  work_dir=str(tmp_path / "jax"))
    pargs, pds, pkind = port_datasets.auto_dataset(
        dict(ARGS, dataset_root=str(proot)))
    tp = port_trainer.make_trainer(pargs, pds, pkind,
                                   work_dir=str(tmp_path / "port"),
                                   device="cpu")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tj.state.params), tp.model.cfg))
    want, got = tj.pasp(), tp.pasp()
    assert sorted(got) == [1, 2, 3]
    for level in (1, 2, 3):
        assert np.isfinite(got[level])
        assert got[level] == pytest.approx(want[level], abs=1e-4), level
    log = (tp.log_save_dir / "log.txt").read_text()
    for level in (1, 2, 3):
        assert f"Run model for perturbed test level {level}..." in log
    assert log.count("Delta_RMSE=") == 3 and log.count("L(P, P') is") == 3


def test_cli_trains_physprop_perturb(roots, tmp_path):
    """``glam_tpu_torch.run`` trains physprop_perturb on its Label split
    and ends in its final line."""
    from glam_tpu_torch import run
    trainer = run.main(["--dataset", "physprop_perturb", "--dataset_root",
                        str(roots[1]), "--epochs", "1", "--e_dim", "16",
                        "--hid_dim_alpha", "1", "--message_steps", "1",
                        "--platform", "cpu", "--work_dir", str(tmp_path)])
    assert trainer.task == "regression"
    assert (len(trainer.train_loader.graphs), len(trainer.valid_loader.graphs),
            len(trainer.test_loader.graphs)) == (200, 50, 50)
    last = (trainer.log_save_dir / "log.txt").read_text().strip() \
        .splitlines()[-1]
    assert set(ast.literal_eval(last.split("|")[1])) == {
        "ci", "mse", "rmse", "r2"}
