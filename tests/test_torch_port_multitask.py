"""Multitask training of the port against the JAX package, on the CPU:
one epoch on ``datasets/tox21_demo`` (12 tasks with NaN holes, which
become label -1 and are masked out of the loss) with ``bcel`` (the
``binary_nan_bce`` trainer, one logit per task; the loss the search
space draws for classification) and ``ce`` (the ``binary_nan`` trainer,
two logits per task), from the same weights; then the single-graph
multitask blend of two such runs.  (``bce`` routes to the same trainer
but takes probabilities: on logits it is NaN from the first batch in
both packages, since float32 rounds its clip at 1 - 1e-12 to 1.)

Tolerances: losses 1e-4 relative, as ``test_torch_port_train.py`` holds
the one-task trainer (float32 sums in other orders through an epoch of
Adam); the blend 1e-12 (float64 metrics of the same arrays).
"""
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from glam_tpu.automl import ensemble as jax_ensemble
from glam_tpu.data import datasets as jax_datasets
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert
from glam_tpu_torch.automl import ensemble as port_ensemble
from glam_tpu_torch.automl import summary as port_summary
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.train import metrics as port_metrics
from glam_tpu_torch.train import trainer as port_trainer

TOX21 = Path(__file__).resolve().parents[1] / "datasets" / "tox21_demo"
ARGS = {"dataset": "tox21", "epochs": 1, "batch_size": 64, "e_dim": 32,
        "hid_dim_alpha": 1, "message_steps": 2, "optim": "Adam",
        "lr": 1e-3, "seed": 3, "mol_block": "_TripletMessage",
        "graph_norm": "_PairNorm", "pre_act": "CELU", "graph_act": "CELU",
        "flat_act": "CELU", "pre_do": "_None()", "graph_do": "_None()",
        "flat_do": "_None()", "end_do": "_None()", "note": "mt"}


def _record_losses(trainer):
    rec = {"trn": [], "val": []}
    train, valid = trainer.train_iterations, trainer.valid_iterations

    def train_it(*a):
        rec["trn"].append(train(*a))
        return rec["trn"][-1]

    def valid_it(mode="valid"):
        out = valid(mode)
        if mode != "inference":
            rec["val"].append(out[0])
        return out

    trainer.train_iterations, trainer.valid_iterations = train_it, valid_it
    return rec


@pytest.mark.parametrize("loss,kind,out_dim", [
    ("bcel", "binary_nan_bce", 12), ("ce", "binary_nan", 24)])
def test_multitask_trainer_matches_jax_and_blends(tmp_path, loss, kind,
                                                  out_dim):
    jroot, proot = tmp_path / "j", tmp_path / "p"
    for root in (jroot, proot):
        shutil.copytree(TOX21 / "raw", root / "raw")
    args, ds, got_kind = jax_datasets.auto_dataset(
        dict(ARGS, dataset_root=str(jroot), loss=loss))
    assert got_kind == kind and args["out_dim"] == out_dim
    tj = jax_trainer.make_trainer(args, ds, kind,
                                  work_dir=str(tmp_path / "jax"))
    pargs, pds, pkind = port_datasets.auto_dataset(
        dict(ARGS, dataset_root=str(proot), loss=loss))
    assert pkind == kind and pargs["out_dim"] == out_dim
    assert pds.num_tasks == 12
    work = tmp_path / "port"
    tp = port_trainer.make_trainer(pargs, pds, pkind, work_dir=str(work),
                                   device="cpu")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tj.state.params), tp.model.cfg))
    rec_j, rec_p = _record_losses(tj), _record_losses(tp)
    tj.train_and_test()
    tp.train_and_test()
    # one epoch's train and val losses, then the best checkpoint's val
    # and test losses
    assert len(rec_p["trn"]) == 1 and len(rec_p["val"]) == 3
    np.testing.assert_allclose(rec_p["trn"], rec_j["trn"], rtol=1e-4)
    np.testing.assert_allclose(rec_p["val"], rec_j["val"], rtol=1e-4)
    assert all(np.isfinite(rec_p["trn"] + rec_p["val"]))

    # a second run from another seed, then the blend of both
    other = port_trainer.make_trainer(dict(pargs, seed=4), pds, pkind,
                                      work_dir=str(work), device="cpu")
    other.train_and_test()
    outs = [t.valid_iterations(mode="inference") for t in (tp, other)]
    if kind == "binary_nan":                     # (y, score, pred)
        outs = [(o[1], o[0]) for o in outs]
    want = port_metrics.binary_metrics_multi_target_nan(
        outs[0][1], np.mean([o[0] for o in outs], axis=0))
    logs_dir = work / "log_tox21"
    sel = port_summary.select_top_runs(logs_dir, "tox21", 2)
    got = port_ensemble.blend_and_inference(
        [r["id"] for r in sel], [r["config"] for r in sel], work,
        log=lambda *_: None, device="cpu")
    ref = jax_ensemble._blend_outputs(kind, "tox21", outs)
    assert got.keys() == want.keys() == ref.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
        assert got[k] == pytest.approx(float(ref[k]), rel=1e-12,
                                       abs=1e-12), k
