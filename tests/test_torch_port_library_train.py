"""Training with the rest of the layer library on the CPU: the CLI's
default configuration (``_NNConv``, ``GlobalPool5``, ``_PairNorm``)
trains; a model with ``_BatchNorm`` keeps its running statistics in
``best_save.pt`` and ``last_save.pt``, serves with them, and resumes
with them exactly as a straight-through run."""
import ast
from pathlib import Path

import numpy as np
import torch

from glam_tpu_torch import run
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.serve import Predictor
from glam_tpu_torch.train import trainer as port_trainer
from test_torch_port_train import _raw_copy, _record_losses

BN_ARGS = {"dataset": "demo", "batch_size": 16, "e_dim": 16,
           "hid_dim_alpha": 1, "loss": "bcel", "optim": "Adam", "lr": 1e-3,
           "seed": 5, "mol_block": "_TripletMessageLight",
           "mol_readout": "Set2Set", "graph_norm": "_BatchNorm",
           "flat_norm": "_BatchNorm", "end_norm": "_LayerNorm"}


def test_cli_default_config_trains_nnconv(tmp_path, capsys):
    root = _raw_copy(tmp_path / "data", "demo", 60)
    trainer = run.main(["--dataset", "demo", "--dataset_root", str(root),
                        "--epochs", "1", "--loss", "bcel", "--e_dim", "64",
                        "--platform", "cpu", "--work_dir",
                        str(tmp_path / "runs")])
    cfg = trainer.model.cfg
    assert (cfg.mol_block, cfg.mol_readout, cfg.graph_norm) == (
        "_NNConv", "GlobalPool5", "_PairNorm")
    last = capsys.readouterr().out.strip().splitlines()[-1]
    loss_info, test, val = [ast.literal_eval(p) for p in last.split("|")]
    assert all(np.isfinite(v) for v in loss_info.values())
    assert "auc" in test and "valauc" in val


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith((".mean", ".var"))}


def test_batchnorm_checkpoint_serves_and_resumes(tmp_path):
    root = _raw_copy(tmp_path / "data", "demo", 80)
    args, ds, kind = port_datasets.auto_dataset(
        dict(BN_ARGS, dataset_root=str(root)))

    def trainer(epochs, where):
        return port_trainer.make_trainer(dict(args, epochs=epochs), ds, kind,
                                         work_dir=str(tmp_path / where),
                                         device="cpu")

    straight = trainer(2, "a")
    init = _stats(straight.model)
    assert set(init) == {f"mol.{b}.norm.{s}" for b in ("conv", "flat")
                         for s in ("mean", "var")}
    rec_a = _record_losses(straight, False)
    straight.train()
    moved = _stats(straight.model)
    assert all(not torch.equal(moved[k], init[k]) for k in init)

    first = trainer(1, "b")
    first.train()
    for name in ("best_save.pt", "last_save.pt"):
        saved = torch.load(first.log_save_dir / name, weights_only=True)
        for k, v in _stats(first.model).items():
            assert torch.equal(saved["state_dict"][k], v), (name, k)

    # served with its running statistics: the eval-mode model's outputs
    smis = [g.smi for g in ds.test[:12]]
    pred = Predictor.from_checkpoint(first.log_save_dir, device="cpu")
    got = pred.predict_smiles(smis)
    assert np.isfinite(got).all()
    best = torch.load(first.log_save_dir / "best_save.pt",
                      weights_only=True)["state_dict"]
    pred.model.load_state_dict({k: (torch.zeros_like(v) if k.endswith(
        ".mean") else v) for k, v in best.items()})
    assert not np.allclose(pred.predict_smiles(smis), got)

    second = trainer(2, "c")
    assert second.resume(first.log_save_dir) == 1
    rec_c = _record_losses(second, False)
    second.train()
    assert rec_c["trn"] == rec_a["trn"][1:]
    assert rec_c["val"] == rec_a["val"][1:]
    for (k, a), b in zip(straight.model.state_dict().items(),
                         second.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert Path(second.log_save_dir) == Path(first.log_save_dir)
