"""The port's training slice against the JAX package, on the CPU: losses,
optimizers and ReduceLROnPlateau, the numpy metrics against
scikit-learn's, ``MolDataset``, PairNorm, training-mode noise, the
trainer (2 epochs from the same weights), resume, and the CLI.

Tolerances, each with its reason: losses rtol 1e-6 (the same float32
formulas); optimizers rtol 1e-5, atol 1e-5 after 12 steps of lr 1e-2
(optax computes the bias corrections 1 - beta^t in float32, where the
cancellation leaves ~1e-4 relative error at small t; the port computes
them in float64, so each Adam or RAdam step differs by up to ~1e-4 of
its size); metrics 1e-12 (float64 either way); trainer losses 1e-4 relative
and its final metrics 1e-3 (float32 sums in other orders through two
epochs of Adam).
"""
import ast
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn import metrics as skm

from glam_tpu.data import datasets as jax_datasets
from glam_tpu.nn import model as jax_model
from glam_tpu.nn import norms as jax_norms
from glam_tpu.run import build_parser as jax_parser
from glam_tpu.train import losses as jax_losses
from glam_tpu.train import metrics as jax_metrics
from glam_tpu.train import optim as jax_optim
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert, run
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.nn.activations import Activation, celu
from glam_tpu_torch.nn.blocks import Dropout
from glam_tpu_torch.nn.norms import PairNorm
from glam_tpu_torch.train import losses as port_losses
from glam_tpu_torch.train import metrics as port_metrics
from glam_tpu_torch.train import optim as port_optim
from glam_tpu_torch.train import trainer as port_trainer
from test_torch_port_model import _cfg, _np_tree

DEMO_RAW = Path(__file__).resolve().parents[1] / "datasets" / "demo" / "raw"


# ---------------------------------------------------------------- losses
def _loss_inputs(name, rng):
    n = 16
    w = (rng.rand(n) > 0.25).astype(np.float32)
    if name in ("mse", "mae", "huber", "smae"):
        return rng.randn(n) * 2, rng.randn(n), w
    if name in ("bce", "bcen"):
        return rng.rand(n), (rng.rand(n) > 0.5) * 1.0, w
    if name in ("bcel", "bceln"):
        return rng.randn(n) * 3, (rng.rand(n) > 0.5) * 1.0, w
    if name == "kl":
        return np.log(rng.dirichlet(np.ones(4), n)), rng.dirichlet(
            np.ones(4), n), w[:, None].repeat(4, 1)
    if name == "hinge":
        return rng.randn(n), np.where(rng.rand(n) > 0.5, 1.0, -1.0), w
    if name == "nll":
        return np.log(rng.dirichlet(np.ones(3), n)), rng.randint(0, 3, n), w
    if name == "focal":
        return rng.randn(n, 2), rng.randint(0, 2, n), w
    if name == "mtce":
        return rng.randn(n, 3, 2), rng.randint(-1, 2, (n, 3)), np.ones(
            (n, 3), np.float32)
    return rng.randn(n, 3), rng.randint(0, 3, n), w       # ce, wce


@pytest.mark.parametrize("name", sorted(jax_losses.LOSSES))
def test_loss_matches_jax(name):
    rng = np.random.RandomState(0)
    pred, target, weight = (np.asarray(a, np.float32)
                            for a in _loss_inputs(name, rng))
    for w in (None, weight):
        want = float(jax_losses.get_loss(name)(
            jnp.asarray(pred), jnp.asarray(target),
            None if w is None else jnp.asarray(w)))
        got = float(port_losses.get_loss(name)(
            torch.from_numpy(pred), torch.from_numpy(target),
            None if w is None else torch.from_numpy(w)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), (name, w)
    assert set(port_losses.LOSSES) == set(jax_losses.LOSSES)
    assert port_losses.CE_STYLE == jax_losses.CE_STYLE
    assert port_losses.BCE_STYLE == jax_losses.BCE_STYLE


def test_class_weighted_cross_entropy_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(12, 2).astype(np.float32)
    target = rng.randint(0, 2, 12).astype(np.float32)
    cw = np.asarray([0.3, 2.5], np.float32)
    want = float(jax_losses.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(target),
                                          class_weight=jnp.asarray(cw)))
    got = float(port_losses.cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(target),
                                          class_weight=torch.from_numpy(cw)))
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------ optimizers
@pytest.fixture(scope="module")
def param_tree(request):
    from glam_tpu.data.batching import GraphLoader as JaxLoader
    sample_graphs = request.getfixturevalue("sample_graphs")
    jb = next(iter(JaxLoader(sample_graphs, batch_size=6, num_tasks=1)))
    cfg = _cfg(jax_model.ModelConfig)
    return _np_tree(jax_model.Architecture(cfg).init(
        jax.random.PRNGKey(2), jb, True)["params"])


@pytest.mark.parametrize("name,lr", [("Adam", 1e-2), ("SGD", 1e-1),
                                     ("Ranger", 1e-2)])
def test_optimizer_matches_optax(param_tree, name, lr):
    """12 steps from one parameter tree with the same random gradients
    (both RAdam branches, lookahead syncs at steps 6 and 12, gradient
    centralization of [in, out] and [out, in] weights), and a learning
    rate changed after step 8."""
    cfg = _cfg(port_model.ModelConfig)
    rng = np.random.RandomState(5)
    tx = jax_optim.make_optimizer(name, lr, k=6)
    params = jax.tree_util.tree_map(jnp.asarray, param_tree)
    state = tx.init(params)
    model = port_model.Architecture(cfg)
    model.load_state_dict(convert.state_dict_from_jax(param_tree, cfg))
    opt = port_optim.make_optimizer(name, model.named_parameters(), lr, k=6)
    for step in range(12):
        if step == 8:
            state = jax_optim.set_learning_rate(state, lr / 3)
            port_optim.set_learning_rate(opt, lr / 3)
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32) + 0.5,
            param_tree)
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        for key, g in convert.state_dict_from_jax(grads, cfg).items():
            model.get_parameter(key).grad = g
        opt.step()
    assert port_optim.get_learning_rate(opt) == pytest.approx(
        jax_optim.get_learning_rate(state))
    want = convert.state_dict_from_jax(_np_tree(params), cfg)
    for key, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_gc_dims_follow_the_jax_layout():
    assert port_optim.gc_dims("mol.lin0.linear.weight", 2) == (1,)
    assert port_optim.gc_dims("mol.conv.gru.weight_ih", 2) == (1,)
    assert port_optim.gc_dims("mol.conv.conv.weight_node", 2) == (0,)
    assert port_optim.gc_dims("mol.conv.conv.weight_triplet_att", 2) == (0,)
    assert port_optim.gc_dims("mol.conv.conv.bias", 1) == ()


def test_reduce_lr_on_plateau_matches_jax():
    rng = np.random.RandomState(3)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 5),
                              0.5 + rng.rand(30) * 0.01, [0.1],
                              0.1 + rng.rand(20) * 0.01])
    a = jax_optim.ReduceLROnPlateau(factor=0.5, patience=3, min_lr=1e-3)
    b = port_optim.ReduceLROnPlateau(factor=0.5, patience=3, min_lr=1e-3)
    lr_a = lr_b = 0.1
    seen = []
    for m in metrics:
        lr_a, lr_b = a.step(float(m), lr_a), b.step(float(m), lr_b)
        assert lr_a == lr_b and a.num_bad == b.num_bad
        seen.append(lr_b)
    assert min(seen) == 1e-3 and len(set(seen)) > 3
    c = port_optim.ReduceLROnPlateau()
    c.load_state_dict(b.state_dict())
    assert (c.best, c.num_bad) == (b.best, b.num_bad)


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("case", ["random", "ties", "single_class", "nan"])
def test_binary_metrics_match_sklearn(case):
    rng = np.random.RandomState(11)
    y = (rng.rand(60, 3) > 0.6).astype(np.float32)
    score = rng.rand(60, 3)
    if case == "ties":
        score = np.round(score * 4) / 4          # few distinct scores
    elif case == "single_class":
        y[:, 1] = 0.0                            # task 1 is skipped
    elif case == "nan":
        y[rng.rand(60, 3) > 0.7] = -1            # unlabelled entries
    for pred in (None, (score > 0.4).astype(int)):
        want = jax_metrics.binary_metrics_multi_target_nan(y, score, pred)
        got = port_metrics.binary_metrics_multi_target_nan(y, score, pred)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    keep = y[:, 0] >= 0
    assert port_metrics.roc_auc(y[keep, 0], score[keep, 0]) == \
        pytest.approx(skm.roc_auc_score(y[keep, 0], score[keep, 0]),
                      abs=1e-12)


def test_binary_metrics_without_two_classes_are_nan():
    got = port_metrics.binary_metrics_multi_target_nan(np.zeros(5),
                                                       np.arange(5.0))
    assert all(np.isnan(v) for v in got.values())


@pytest.mark.parametrize("case", ["random", "ties", "constant_target"])
def test_regression_metrics_match_sklearn(case):
    rng = np.random.RandomState(12)
    y, p = rng.randn(40), rng.randn(40)
    if case == "ties":
        y, p = np.round(y), np.round(p)
    elif case == "constant_target":
        y = np.full(40, 1.5)
    want = jax_metrics.regression_metrics(y, p)
    got = port_metrics.regression_metrics(y, p)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert port_metrics.auto_metrics("esol") == \
        jax_metrics.auto_metrics("esol")
    assert port_metrics.auto_metrics("demo") == \
        jax_metrics.auto_metrics("demo")


# --------------------------------------------------------------- dataset
def _raw_copy(tmp_path, name, n=None, csv_text=None):
    root = tmp_path / name
    (root / "raw").mkdir(parents=True)
    if csv_text is not None:
        (root / "raw" / f"{name}.csv").write_text(csv_text)
        return root
    lines = (DEMO_RAW / "demo.csv").read_text().splitlines()
    lines = lines[:n + 1] if n else lines
    (root / "raw" / "demo.csv").write_text("\n".join(lines) + "\n")
    return root


def _same_graphs(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in ("nodes", "edges", "senders", "receivers", "y"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
        assert ga.smi == gb.smi


@pytest.mark.parametrize("split", ["random", "scaffold"])
def test_mol_dataset_matches_jax(tmp_path, split):
    jroot = _raw_copy(tmp_path / "j", "demo", 300)
    proot = _raw_copy(tmp_path / "p", "demo", 300)
    want = jax_datasets.MolDataset(str(jroot), "demo", split=split,
                                   split_seed=7)
    got = port_datasets.MolDataset(str(proot), "demo", split=split,
                                   split_seed=7)
    _same_graphs(got.graphs, want.graphs)
    for part in ("train", "val", "test"):
        _same_graphs(getattr(got, part), getattr(want, part))
    assert sorted(p.name for p in (proot / "processed").iterdir()) == \
        sorted(p.name for p in (jroot / "processed").iterdir())
    # either package reads the other's cache and split files
    shutil.rmtree(proot / "processed")
    shutil.copytree(jroot / "processed", proot / "processed")
    again = port_datasets.MolDataset(str(proot), "demo", split=split,
                                     split_seed=7)
    _same_graphs(again.train, want.train)


def test_classification_nan_labels_and_invalid_smiles(tmp_path):
    text = ("smiles,FDA_APPROVED,CT_TOX\n"
            "CCO,1,0\nc1ccccc1,,1\nC1CC,1,1\nCC(=O)O,0,\n"
            "CCN,1,1\nCCCl,,\n")
    jroot = _raw_copy(tmp_path / "j", "clintox", csv_text=text)
    proot = _raw_copy(tmp_path / "p", "clintox", csv_text=text)
    want = jax_datasets.MolDataset(str(jroot), "clintox")
    got = port_datasets.MolDataset(str(proot), "clintox")
    _same_graphs(got.graphs, want.graphs)
    assert len(got.graphs) == 5                  # C1CC is skipped
    assert (np.stack([g.y for g in got.graphs]) == -1).sum() == 4


def test_auto_dataset_matches_jax(tmp_path):
    for loss, kind, out_dim in (("bcel", "binary_nan_bce", 1),
                                ("ce", "binary_nan", 2)):
        root = _raw_copy(tmp_path / loss, "demo", 40)
        args = {"dataset": "demo", "dataset_root": str(root), "loss": loss}
        _, ds, got_kind = port_datasets.auto_dataset(dict(args))
        _, _, want_kind = jax_datasets.auto_dataset(dict(args))
        assert got_kind == want_kind == kind
        assert port_datasets.auto_dataset(dict(args))[0]["out_dim"] == \
            out_dim
    # a pair dataset routes as the JAX package routes it
    ddi = tmp_path / "ddi" / "raw"
    ddi.mkdir(parents=True)
    csv_lines = (DEMO_RAW.parents[1] / "ddi_demo" / "raw"
                 / "drugbank_caster.csv").read_text().splitlines()[:41]
    (ddi / "drugbank_caster.csv").write_text("\n".join(csv_lines) + "\n")
    args = {"dataset": "drugbank_caster", "dataset_root": str(ddi.parent)}
    got_args, _, got_kind = port_datasets.auto_dataset(dict(args))
    want_args, _, want_kind = jax_datasets.auto_dataset(dict(args))
    assert got_kind == want_kind == "pair_ddi"
    assert got_args == want_args


# ------------------------------------------------------ norms and noise
@pytest.mark.parametrize("graphs", [True, False])
def test_pair_norm_matches_jax(graphs):
    rng = np.random.RandomState(4)
    x = rng.randn(20, 6).astype(np.float32)
    node_graph = np.repeat(np.arange(4), [3, 7, 1, 9])
    n_node = np.bincount(node_graph, minlength=5)        # one empty graph
    kw_j = dict(node_graph=jnp.asarray(node_graph),
                n_node=jnp.asarray(n_node)) if graphs else {}
    kw_t = dict(node_graph=torch.from_numpy(node_graph),
                n_node=torch.from_numpy(n_node)) if graphs else {}
    norm = jax_norms.PairNorm()
    want = np.asarray(norm.apply({}, jnp.asarray(x), **kw_j))
    got = PairNorm()(torch.from_numpy(x), **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_training_noise_range_mean_and_seed():
    x = torch.full((200_000,), -3.0)
    slope = -Activation("RReLU")(x, torch.Generator().manual_seed(1)) / 3
    assert slope.min() >= 1 / 8 and slope.max() <= 1 / 3
    assert float(slope.mean()) == pytest.approx((1 / 8 + 1 / 3) / 2,
                                                abs=2e-3)
    drop = Dropout(0.2)
    y = drop(torch.ones(200_000), torch.Generator().manual_seed(2))
    assert set(torch.unique(y).tolist()) == {0.0, 1.25}
    assert float((y == 0).float().mean()) == pytest.approx(0.2, abs=5e-3)
    assert float(y.mean()) == pytest.approx(1.0, abs=1e-2)
    again = drop(torch.ones(200_000), torch.Generator().manual_seed(2))
    assert torch.equal(y, again)
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="Generator"):
        Dropout(0.2)(x)


def test_celu_derivative_at_zero_is_one():
    """d celu / dx at 0 is 1, as the JAX package's gives it (an edgeless
    node's conv output is the bias, 0 at initialisation)."""
    x = torch.zeros(3, requires_grad=True)
    celu(x).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]
    xj = jnp.zeros(3)
    from glam_tpu.nn.activations import celu as jax_celu
    assert np.asarray(jax.grad(lambda v: jax_celu(v).sum())(xj)).tolist() \
        == [1.0, 1.0, 1.0]


# --------------------------------------------------------------- trainer
TRAIN_ARGS = {"dataset": "demo", "epochs": 2, "batch_size": 32, "e_dim": 32,
              "hid_dim_alpha": 2, "loss": "bcel", "optim": "Adam",
              "lr": 1e-3, "seed": 3, "mol_block": "_TripletMessage",
              "graph_norm": "_PairNorm", "pre_act": "CELU",
              "graph_act": "CELU", "flat_act": "CELU", "pre_do": "_None()",
              "graph_do": "_None()", "flat_do": "_None()",
              "end_do": "_None()"}


def _record_losses(trainer, jax_side):
    rec = {"trn": [], "val": []}
    train, valid = trainer.train_iterations, trainer.valid_iterations

    def train_it(*a):
        rec["trn"].append(train(*a))
        return rec["trn"][-1]

    def valid_it(mode="valid"):
        out = valid(mode)
        rec["val"].append(out[0])
        return out

    trainer.train_iterations, trainer.valid_iterations = train_it, valid_it
    return rec


def _final_line(run_dir):
    last = (Path(run_dir) / "log.txt").read_text().strip().splitlines()[-1]
    return [ast.literal_eval(p) for p in last.split("|")]


def test_trainer_matches_jax(tmp_path):
    """JAX make_trainer and the port's on 100 demo molecules, from the
    same weights: per-epoch losses and the final line's metrics."""
    root = _raw_copy(tmp_path / "data", "demo", 100)
    args = dict(TRAIN_ARGS, dataset_root=str(root))
    args, ds, kind = jax_datasets.auto_dataset(args)
    tj = jax_trainer.make_trainer(args, ds, kind,
                                  work_dir=str(tmp_path / "jax"))
    pds = port_datasets.MolDataset(str(root), "demo")
    tp = port_trainer.make_trainer(args, pds, kind,
                                   work_dir=str(tmp_path / "port"),
                                   device="cpu")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(tj.state.params), tp.model.cfg))
    rec_j, rec_p = _record_losses(tj, True), _record_losses(tp, False)
    tj.train_and_test()
    tp.train_and_test()
    assert len(rec_j["trn"]) == len(rec_p["trn"]) == 2
    np.testing.assert_allclose(rec_p["trn"], rec_j["trn"], rtol=1e-4)
    np.testing.assert_allclose(rec_p["val"], rec_j["val"], rtol=1e-4)
    for got, want in zip(_final_line(tp.log_save_dir),
                         _final_line(tj.log_save_dir)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-3), k
    assert (tp.log_save_dir / "best_save.pt").is_file()
    assert json.loads((tp.log_save_dir / "result.json").read_text())[
        "epochs_run"] == 2


def test_resume_equals_straight_through(tmp_path):
    """With the CLI's noise (Dropout, RReLU): 1 epoch, resume, 1 more
    equals 2 epochs straight through."""
    root = _raw_copy(tmp_path / "data", "demo", 80)
    args = dict(TRAIN_ARGS, dataset_root=str(root), e_dim=16,
                flat_do="Dropout(0.2)", end_do="Dropout(0.2)",
                pre_act="RReLU", graph_act="RReLU", flat_act="RReLU")
    args, ds, kind = port_datasets.auto_dataset(args)

    def trainer(epochs, where):
        return port_trainer.make_trainer(dict(args, epochs=epochs), ds,
                                         kind, work_dir=str(tmp_path / where),
                                         device="cpu")

    straight = trainer(2, "a")
    rec_a = _record_losses(straight, False)
    straight.train()
    first = trainer(1, "b")
    first.train()
    second = trainer(2, "c")
    assert second.resume(first.log_save_dir) == 1
    rec_c = _record_losses(second, False)
    second.train()
    assert rec_c["trn"] == rec_a["trn"][1:]
    assert rec_c["val"] == rec_a["val"][1:]
    for (k, a), b in zip(straight.model.state_dict().items(),
                         second.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert second.log_save_dir == first.log_save_dir
    with pytest.raises(ValueError, match="resume mismatch"):
        port_trainer.make_trainer(dict(args, seed=9), ds, kind,
                                  work_dir=str(tmp_path / "d"),
                                  device="cpu").resume(first.log_save_dir)


# ------------------------------------------------------------------- CLI
def test_cli_trains_on_the_cpu(tmp_path, capsys):
    root = _raw_copy(tmp_path / "data", "demo", 60)
    trainer = run.main(["--dataset", "demo", "--dataset_root", str(root),
                        "--epochs", "1", "--loss", "bcel", "--mol_block",
                        "_TripletMessage", "--e_dim", "16", "--platform",
                        "cpu", "--work_dir", str(tmp_path / "runs"),
                        "--pallas", "1", "--scan_steps", "4"])
    loss_info, test, val = _final_line(trainer.log_save_dir)
    assert set(loss_info) == {"testloss", "valloss"}
    assert all(np.isfinite(v) for v in loss_info.values())
    assert "auc" in test and "valauc" in val
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "{'testloss'")
    from glam_tpu_torch.serve import Predictor
    pred = Predictor.from_checkpoint(trainer.log_save_dir, device="cpu")
    assert np.isfinite(pred.predict_smiles(["CCO", "c1ccccc1"])).all()


def _pro_shards_argv(tmp_path, flag):
    root = _raw_copy(tmp_path / "data", "demo", 20)
    return ["--dataset", "demo", "--dataset_root", str(root), "--loss",
            "bcel", "--platform", "cpu", "--work_dir", str(tmp_path)] + flag


def test_cli_pro_shards_excludes_n_devices(tmp_path):
    """``--pro_shards`` with ``--n_devices`` raises the JAX CLI's error
    before any rank starts."""
    argv = _pro_shards_argv(tmp_path, ["--n_devices", "2", "--pro_shards",
                                       "2"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        run.main(argv)


def test_cli_pro_shards_needs_a_dti_dataset(tmp_path):
    """``--pro_shards`` on a property dataset raises the JAX CLI's error
    before any rank starts."""
    argv = _pro_shards_argv(tmp_path, ["--pro_shards", "2"])
    with pytest.raises(ValueError, match="DTI datasets only"):
        run.main(argv)


def test_cli_parser_matches_jax():
    want = {a.dest: a.default for a in jax_parser()._actions}
    got = {a.dest: a.default for a in run.build_parser()._actions}
    assert got == want
    assert run.resolve_run_device({"platform": "cpu"}) == "cpu"
    assert run.resolve_run_device({"gpu": 2}) == "cuda:2"
    with pytest.raises(ValueError):
        run.resolve_run_device({"platform": "tpu"})
