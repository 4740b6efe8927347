"""The pair families' training and serving in the port against the JAX
package, on the CPU.

Tolerances, each with its reason: metrics 1e-12 (float64 either way;
the JAX package's come from scikit-learn); pair losses 1e-6 relative
(the same float32 formulas); the DDI trainer's per-epoch losses 1e-4
relative and its final line's metrics 1e-3 (float32 sums in other orders
through two epochs of Adam, as tests/test_torch_port_train.py); served
scores against the trainer's own eval 1e-5 (the same float32 forward on
batches of another size).
"""
import ast
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glam_tpu.data import pair_datasets as jax_pairs
from glam_tpu.train import metrics as jax_metrics
from glam_tpu.train import pair_trainer as jax_pair_trainer
from glam_tpu_torch import convert, run
from glam_tpu_torch.data import pair_datasets as port_pairs
from glam_tpu_torch.serve import PairPredictor, Predictor
from glam_tpu_torch.train import metrics as port_metrics
from glam_tpu_torch.train import pair_trainer as port_pair_trainer
from test_torch_port_model import _np_tree
from test_torch_port_train import TRAIN_ARGS, _record_losses

DATA = Path(__file__).resolve().parents[1] / "datasets"
DDI_CSV = DATA / "ddi_demo" / "raw" / "drugbank_caster.csv"
SMALL = ["--mol_block", "_TripletMessage", "--e_dim", "32",
         "--hid_dim_alpha", "2", "--message_steps", "2", "--epochs", "1",
         "--platform", "cpu"]


def _final_line(run_dir):
    last = (Path(run_dir) / "log.txt").read_text().strip().splitlines()[-1]
    parts = [ast.literal_eval(p) for p in last.split("|")]
    for d in parts:
        assert d and all(isinstance(v, float) and np.isfinite(v)
                         for v in d.values()), last
    return parts


# ----------------------------------------------------------------- metrics
def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        w = float(want[k])
        if np.isnan(w):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(w, rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("case", ["random", "tied", "single_class"])
def test_binary_and_screening_metrics(case):
    rng = np.random.RandomState({"random": 0, "tied": 1,
                                 "single_class": 2}[case])
    n = 400
    y = (rng.rand(n) < 0.2).astype(np.float64)
    s = rng.rand(n)
    if case == "tied":
        s = np.round(s, 1)                  # ten distinct scores
    if case == "single_class":
        y[:] = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # scikit-learn's, one class
        want = jax_metrics.binary_metrics(y, s)
    _close(port_metrics.binary_metrics(y, s), want)
    pred = (s > 0.3).astype(int)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_metrics.binary_metrics(y, s, pred)
    _close(port_metrics.binary_metrics(y, s, pred), want)
    if case == "single_class":
        y[:] = 1.0                          # all actives: EF defined
    _close(port_metrics.screening_metrics(y, s, pred),
           jax_metrics.screening_metrics(y, s, pred))
    for thr in (0.001, 0.01, 0.05):
        assert port_metrics.enrichment_factor_single(y, s, thr) == \
            jax_metrics.enrichment_factor_single(y, s, thr)
    assert port_metrics.bedroc_score(y, s) == pytest.approx(
        jax_metrics.bedroc_score(y, s), rel=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_class_metrics(seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 3, 90)
    score = rng.rand(90, 3)
    _close(port_metrics.multi_class_metrics(y, score),
           jax_metrics.multi_class_metrics(y, score))
    pred = np.where(rng.rand(90) < 0.5, 2, 0)     # class 1 never predicted
    _close(port_metrics.multi_class_metrics(y, score, pred),
           jax_metrics.multi_class_metrics(y, score, pred))


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("task,loss", [
    ("pair_binary_bce", "bcel"), ("pair_multiclass", "ce"),
    ("pair_regression", "mse"), ("pair_binary", "ce"),
    ("pair_screening", "wce"), ("pair_binary", "focal")])
def test_pair_losses(task, loss):
    rng = np.random.RandomState(3)
    G = 17
    out_dim = {"pair_binary_bce": 1, "pair_multiclass": 3,
               "pair_regression": 1}.get(task, 2)
    out = (rng.randn(G, out_dim) * 2).astype(np.float32)
    y = rng.randint(0, max(out_dim, 2), (G, 1)).astype(np.float32)
    if task == "pair_regression":
        y = rng.randn(G, 1).astype(np.float32)
    gmask = rng.rand(G) < 0.8
    gmask[-1] = False
    y[-1] = -1.0                                   # the padding slot
    cw = port_pairs.LITPCBADataset(str(DATA / "scr_demo")).class_weights
    want = jax_pair_trainer.make_pair_loss_fn(task, loss, 3, cw)(
        jnp.asarray(out), jnp.asarray(y), jnp.asarray(gmask))
    got = port_pair_trainer.make_pair_loss_fn(task, loss, cw)(
        torch.from_numpy(out), torch.from_numpy(y), torch.from_numpy(gmask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# --------------------------------------------------------- the DDI trainer
@pytest.fixture(scope="module")
def ddi_runs(tmp_path_factory):
    """JAX make_ddi_trainer and the port's on 100 ddi_demo pairs, from
    the same weights, 2 epochs each, with the losses recorded."""
    tmp = tmp_path_factory.mktemp("ddi_train")
    root = tmp / "data"
    (root / "raw").mkdir(parents=True)
    lines = DDI_CSV.read_text().splitlines(keepends=True)[:101]
    (root / "raw" / "drugbank_caster.csv").write_text("".join(lines))
    # the single-graph trainer test's noise-free configuration, with the
    # pair head's activation (lin_out0's) noise-free too
    args = dict(TRAIN_ARGS, dataset="drugbank_caster",
                dataset_root=str(root), end_act="CELU")
    tj = jax_pair_trainer.make_ddi_trainer(
        args, jax_pairs.DDIDataset(str(root)), work_dir=str(tmp / "jax"))
    tp = port_pair_trainer.make_ddi_trainer(
        args, port_pairs.DDIDataset(str(root)), work_dir=str(tmp / "port"),
        device="cpu")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(tj.state.params), tp.model.cfg, pair="homo"))
    rec_j, rec_p = _record_losses(tj, True), _record_losses(tp, False)
    tj.train_and_test()
    tp.train_and_test()
    return tj, tp, rec_j, rec_p


def test_ddi_trainer_matches_jax(ddi_runs):
    tj, tp, rec_j, rec_p = ddi_runs
    assert tp.task == tj.task == "pair_binary_bce"
    assert len(rec_j["trn"]) == len(rec_p["trn"]) == 2
    np.testing.assert_allclose(rec_p["trn"], rec_j["trn"], rtol=1e-4)
    np.testing.assert_allclose(rec_p["val"], rec_j["val"], rtol=1e-4)
    got_lines = _final_line(tp.log_save_dir)
    want_lines = [ast.literal_eval(p.replace("np.float64(", "(")) for p in
                  (Path(tj.log_save_dir) / "log.txt").read_text().strip()
                  .splitlines()[-1].split("|")]
    for got, want in zip(got_lines, want_lines):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-3), k


def test_ddi_checkpoint_serves(ddi_runs):
    _, tp, _, _ = ddi_runs
    score, _ = tp.valid_iterations(mode="inference")
    pairs = [(g1.smi, g2.smi) for g1, g2 in tp.test_loader.pairs]
    pred = PairPredictor.from_checkpoint(tp.log_save_dir, device="cpu",
                                         batch_size=8)
    assert not pred.hetero
    np.testing.assert_allclose(pred.predict_scores(pairs), score, rtol=1e-5,
                               atol=1e-5)
    out = pred.predict_pairs([("xyz", "CCO"), ("CCO", "C1CC"),
                              pairs[0]])
    assert np.isnan(out[:2]).all() and np.isfinite(out[2]).all()
    assert pred.budget1 is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        PairPredictor.from_checkpoint(tp.log_save_dir, device="cuda")
    with pytest.raises(ValueError, match="PairPredictor"):
        Predictor.from_checkpoint(tp.log_save_dir, device="cpu")


# ------------------------------------------------------ the CLI on the CPU
@pytest.fixture(scope="module")
def dti_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dti_cli")
    return run.main(["--dataset", "bindingdb_c", "--dataset_root",
                     str(DATA / "dti_demo"), "--pro_block", "_GATConv",
                     "--work_dir", str(tmp)] + SMALL)


def test_cli_trains_bindingdb(dti_run):
    loss_info, test, val = _final_line(dti_run.log_save_dir)
    assert dti_run.task == "pair_binary" and dti_run.model.hetero
    assert dti_run.model.cfg.pro_block == "_GATConv"
    assert "prauc" in test and "valf1" in val
    assert set(loss_info) == {"testloss", "valloss"}


def test_dti_checkpoint_serves(dti_run):
    y, _, score = dti_run.valid_iterations(mode="inference")
    ds = port_pairs.BindingDBDataset(str(DATA / "dti_demo"))
    pairs = [(g1.smi, g2.smi) for g1, g2 in ds.test]
    pred = PairPredictor.from_checkpoint(dti_run.log_save_dir,
                                         contact_maps=ds.contact_maps,
                                         device="cpu")
    assert pred.hetero
    np.testing.assert_allclose(pred.predict_scores(pairs), score, rtol=1e-5,
                               atol=1e-5)
    out = pred.predict_pairs([("CCO", "NOSUCHPROTEIN"), ("xyz", pairs[0][1]),
                              pairs[1]])
    assert np.isnan(out[:2]).all() and np.isfinite(out[2]).all()
    budgets = (pred.budget1, pred.budget2)
    pred.predict_pairs(pairs[:2])                  # floors stay
    assert (pred.budget1, pred.budget2) == budgets


def test_cli_trains_screening_with_wce(tmp_path):
    trainer = run.main(["--dataset", "ALDH1", "--dataset_root",
                        str(DATA / "scr_demo"), "--work_dir",
                        str(tmp_path)] + SMALL)
    assert trainer.args["loss"] == "wce"
    assert trainer.task == "pair_screening"
    assert trainer.model.cfg.pro_block == "_GCNConv"
    _, test, val = _final_line(trainer.log_save_dir)
    assert {"bedroc", "ef_001", "ef_05", "auc"} <= set(test)
    assert "valbedroc" in val


def test_cli_trains_multiclass_ddi(tmp_path):
    rng = np.random.RandomState(5)
    smis = ["CCO", "CCC", "c1ccccc1", "CCN", "CCOC", "CC(C)C"]
    rows = ["Drug1_SMILES,Drug2_SMILES,label"] + [
        f"{rng.choice(smis)},{rng.choice(smis)},{rng.randint(0, 3)}"
        for _ in range(60)]
    root = tmp_path / "ddimc"
    (root / "raw").mkdir(parents=True)
    (root / "raw" / "drugbank_caster.csv").write_text("\n".join(rows) + "\n")
    trainer = run.main(["--dataset", "drugbank_caster", "--dataset_root",
                        str(root), "--work_dir", str(tmp_path)] + SMALL)
    assert trainer.task == "pair_multiclass"
    assert trainer.model.cfg.out_dim == 3
    _, test, _ = _final_line(trainer.log_save_dir)
    assert set(test) == {"acc", "precision", "recall", "f1"}


def test_cli_pair_batch_raises(tmp_path):
    with pytest.raises(ValueError, match="pair_batch"):
        run.main(["--dataset", "bindingdb_c", "--dataset_root",
                  str(DATA / "dti_demo"), "--pair_batch", "2",
                  "--work_dir", str(tmp_path)] + SMALL)
