"""The sharded DTI trainer (``train/sharded_pair_trainer.py``) and its
entry points (``run --pro_shards``, the solver, ``bench_scaling
--analytic``) against the JAX package, on the CPU.

  * one spawn of 2 gloo ranks (``tests/torch_port_dp_worker.py``, task
    ``strainer``) trains, on 16 BindingDB pairs of ``datasets/dti_demo``
    (12 for the resume):
      - one epoch of SGD without noise from the JAX ``ShardedPairTrainer
        (pro_shards=2)``'s initial weights (carried across by
        ``convert``): the epoch's training loss, the validation losses
        and the final line's losses within rtol 1e-4 of the JAX
        trainer's; its best checkpoint, served by the dense
        ``PairPredictor(device="cpu")``, gives the trainer's evaluation
        logits (1e-4);
      - with RReLU noise, Adam and 4 pairs a step, 2 epochs straight
        through against 1 epoch, ``resume``, then the second: the same
        parameters, bitwise;
      - the step in its graph-ready form (the molecule batch, the shard,
        the labels, the weights and the protein tower's noise through
        static slots, as a captured step takes them), run eagerly: the
        eager step's losses and parameters, bitwise;
      - one epoch of Adam without noise from the same weights as the
        SGD epoch, against the JAX trainer's Adam epoch: first, the first
        step's gradients of both trainers against the dense model's in
        float64 on the same pair, then the epoch's losses at the
        tolerance that evidence gives (``test_adam_epoch_matches_jax``);
  * ``run --pro_shards 2 --platform cpu`` (the launcher starts the gloo
    ranks): the final line parses, its test loss and AUC are those of
    the checkpoint served by ``PairPredictor`` (1e-4), and the AutoML
    summary selects the run; ``--halo ring --pair_batch 2``; the
    screening family (48 LIT-PCBA molecules of ALDH1, ``wce``, ``--halo
    auto``);
  * the CLI's three ``ValueError``s, as the JAX CLI raises them;
  * the solver's trial argv and its resampling by ``sharded_config_ok``
    equal the JAX solver's;
  * ``bench_scaling.analytic`` at the JAX package's rates gives its
    numbers.
"""
import ast
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from glam_tpu.data import pair_datasets as jax_pairs
from glam_tpu.parallel import bench_scaling as jax_bench
from glam_tpu.parallel.sharded_model import insert_pair_params
from glam_tpu.train.sharded_pair_trainer import \
    ShardedPairTrainer as JaxShardedPairTrainer
from glam_tpu_torch import convert, run
from glam_tpu_torch.automl.summary import select_top_runs
from glam_tpu_torch.data.pair_datasets import load_contact_store
from glam_tpu_torch.parallel import bench_scaling
from glam_tpu_torch.serve import PairPredictor
from test_torch_port_model import _np_tree
from test_torch_port_train import _raw_copy
from torch_port_dp_worker import spawn_ranks, wait_ranks

DATA = Path(__file__).resolve().parents[1] / "datasets"
DTI = DATA / "dti_demo" / "raw" / "bindingdb_c"
# SGD: an update linear in the gradient.  Adam's first step divides each
# gradient entry by its own magnitude, so entries near zero, where two
# frameworks' float32 sums differ in sign, move by +-lr either way (one
# epoch of 24 pairs: the validation loss 5.5e-4 apart with Adam, 3.7e-6
# with SGD); test_adam_epoch_matches_jax holds an Adam epoch of 16 pairs
ARGS = {"dataset": "bindingdb_c", "pro_shards": 2, "lr": 1e-3, "seed": 3,
        "optim": "SGD",
        "e_dim": 32, "hid_dim_alpha": 2, "message_steps": 2,
        "mol_block": "_TripletMessage", "pro_block": "_GATConv",
        "pro_readout": "GlobalLAPool", "mol_readout": "GlobalPool5",
        "pre_act": "CELU", "graph_act": "CELU", "flat_act": "CELU",
        "end_act": "CELU", "pre_do": "_None()", "graph_do": "_None()",
        "flat_do": "_None()", "end_do": "_None()", "graph_norm": "_PairNorm",
        "epochs": 1}
SMALL = ["--e_dim", "32", "--hid_dim_alpha", "2", "--message_steps", "2",
         "--mol_block", "_TripletMessage", "--pro_block", "_GATConv",
         "--epochs", "1", "--platform", "cpu"]


def dti_copy(root: Path, n=(40, 12, 12)) -> Path:
    """The first ``n`` (train, dev, test) pairs of dti_demo."""
    out = root / "raw" / "bindingdb_c"
    out.mkdir(parents=True, exist_ok=True)
    for name, k in zip(("train", "dev", "test"), n):
        lines = (DTI / f"{name}.txt").read_text().splitlines()[:k]
        (out / f"{name}.txt").write_text("\n".join(lines) + "\n")
    (out / "protein_maps.npz").write_bytes(
        (DTI / "protein_maps.npz").read_bytes())
    return root


def scr_copy(root: Path, actives=8, inactives=40) -> Path:
    """ALDH1 of scr_demo cut to its first actives and inactives."""
    src = DATA / "scr_demo" / "raw" / "lit_pcba" / "ALDH1"
    out = root / "raw" / "lit_pcba" / "ALDH1"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("ALDH1.contactmap.txt", "ALDH1.seq"):
        (out / name).write_bytes((src / name).read_bytes())
    for name, k in (("actives.smi", actives), ("inactives.smi", inactives)):
        lines = (src / name).read_text().splitlines()[:k]
        (out / name).write_text("\n".join(lines) + "\n")
    return root


def final_line(run_dir):
    lines = (Path(run_dir) / "log.txt").read_text().strip().splitlines()
    return [ast.literal_eval(p) for p in lines[-1].split("|")]


# ------------------------------------------------- the trainer's ranks
@pytest.fixture(scope="module")
def strainer_run(tmp_path_factory):
    """The port's runs on 2 gloo ranks and, meanwhile, the JAX trainer's
    epoch from the same weights, its losses recorded."""
    work = tmp_path_factory.mktemp("strainer")
    root = dti_copy(work / "data", (16, 6, 6))
    small = dti_copy(work / "small", (12, 6, 6))
    jt = JaxShardedPairTrainer(dict(ARGS), jax_pairs.BindingDBDataset(
        str(root)), task="pair_binary", work_dir=str(work / "jax"))
    init = convert.state_dict_from_jax(
        _np_tree(jt._flax_params), convert.config_from_args(jt.args),
        pair="hetero")
    noisy = dict(ARGS, graph_act="RReLU", seed=5, optim="Adam", lr=1e-3,
                 pair_batch=4)
    adam = dict(ARGS, optim="Adam")
    torch.save({
        "parity": {"args": ARGS, "root": str(root), "init": init,
                   "logits": True},
        "adam": {"args": adam, "root": str(root), "init": init,
                 "first_grads": True, "train_only": True},
        "straight": {"args": dict(noisy, epochs=2), "root": str(small),
                     "train_only": True},
        "first": {"args": noisy, "root": str(small), "train_only": True},
        "slots": {"args": noisy, "root": str(small), "train_only": True,
                  "slots": True},
        "resumed": {"args": dict(noisy, epochs=2), "root": str(small),
                    "resume_from": "first", "train_only": True},
    }, work / "strainer.pt")
    (work / "plan.json").write_text('{"tasks": ["strainer"]}')
    procs = spawn_ranks(work, "cpu")
    rec = {"steps": [], "val": []}
    step, valid = jt._step, jt.valid_iterations

    def step_rec(*a):
        out = step(*a)
        rec["steps"].append(float(out[-1]))
        return out

    def valid_rec(mode="valid"):
        out = valid(mode)
        rec["val"].append(out[0])
        return out

    jt._step, jt.valid_iterations = step_rec, valid_rec
    rec["final"] = jt.train_and_test()
    rec["adam"] = _jax_adam_epoch(adam, root, work)
    rec["adam"]["first_grads"] = _jax_first_grads(adam, root, work)
    return wait_ranks(procs, work, timeout=300)["strainer"], rec, root


def _jax_adam_epoch(args, root, work):
    """The JAX trainer's Adam epoch: its steps' losses and its
    validation loss."""
    jt = JaxShardedPairTrainer(dict(args), jax_pairs.BindingDBDataset(
        str(root)), task="pair_binary", work_dir=str(work / "jax_adam"))
    rec = {"steps": [], "val": []}
    step, valid = jt._step, jt.valid_iterations

    def step_rec(*a):
        out = step(*a)
        rec["steps"].append(float(out[-1]))
        return out

    def valid_rec(mode="valid"):
        out = valid(mode)
        rec["val"].append(out[0])
        return out

    jt._step, jt.valid_iterations = step_rec, valid_rec
    jt.train()
    return rec


def _jax_first_grads(args, root, work):
    """The JAX trainer's first step's gradients (the port's layout): its
    optimizer swapped for one whose state keeps the gradients it is
    given and whose update is zero, then its first step of epoch 1."""
    import jax
    import jax.numpy as jnp
    import optax
    jt = JaxShardedPairTrainer(dict(args), jax_pairs.BindingDBDataset(
        str(root)), task="pair_binary", work_dir=str(work / "jax_grads"))
    jt.tx = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))
    jt._build_steps()
    train = jt.splits["train"]
    first = np.random.RandomState(int(args["seed"]) + 1).permutation(
        len(train))[0]
    mol_b, pro_in, y = jt._sample(train[first])
    _, grads, _ = jt._step(jt.params, jt.tx.init(jt.params), mol_b, pro_in,
                           jnp.asarray(y))
    # the sharded layout's gradients written back into the dense tree
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jt._flax_params)
    tree = insert_pair_params(zeros, grads, jt.cfg.pro_block,
                              jt.cfg.pro_readout,
                              graph_norm=jt.cfg.graph_norm)
    return convert.state_dict_from_jax(
        _np_tree(tree), convert.config_from_args(jt.args), pair="hetero")


def test_epoch_matches_jax(strainer_run):
    got, want, _ = strainer_run
    got = got["parity"]
    assert len(want["steps"]) == 16
    np.testing.assert_allclose(got["records"]["trn_losses"],
                               [np.mean(want["steps"])], rtol=1e-4)
    # the epoch's validation, then the final validation and test
    np.testing.assert_allclose(got["records"]["val_losses"],
                               want["val"][:1], rtol=1e-4)
    loss, test, val = got["final"]
    jloss, jtest, jval = want["final"]
    for k in ("testloss", "valloss"):
        assert loss[k] == pytest.approx(jloss[k], rel=1e-4), k
    assert test.keys() == jtest.keys() and val.keys() == jval.keys()
    assert test["auc"] == pytest.approx(jtest["auc"], abs=1e-6)


# The first step's gradients of both frameworks lie within GRAD_NOISE of
# each tensor's largest entry of the dense model's float64 gradient on
# the same pair (float32 sums over a pair's atoms, residues, edges and
# shards in other orders: measured up to 5.4e-5 for the port, 1.2e-5
# for JAX).  A tensor whose float64 gradient is zero to rounding (under
# ZERO of the tree's largest: GlobalLAPool's gate bias, which a softmax
# over every logit does not see) gets noise of either sign in both, within
# GRAD_NOISE of the tree's largest.  Adam's first step moves each entry by
# its sign alone, so the entries the two frameworks' signs set apart are
# noise: their float64 gradient lies within that noise (5 entries on
# this pair).  They drift apart by up to 2 lr a step through the epoch's
# 16 steps (the gate bias moves no loss at all), which moved the epoch's
# losses by 8.1e-6 (training) and 1.6e-5 (validation): held at
# ADAM_RTOL = 1e-4, the SGD epoch's tolerance.
GRAD_NOISE, ZERO, ADAM_RTOL = 1e-4, 1e-12, 1e-4


def test_adam_epoch_matches_jax(strainer_run):
    got, want, _ = strainer_run
    got, want = got["adam"], want["adam"]
    exact = got["float64_grads"]
    sides = {"port": got["first_grads"], "jax": want["first_grads"]}
    assert sides["port"].keys() == exact.keys()
    tree = max(float(g.abs().max()) for g in exact.values())
    noise = {side: 0.0 for side in sides}
    flipped = 0
    for name, g64 in exact.items():
        scale = float(g64.abs().max())
        ref = scale if scale > ZERO * tree else tree
        for side, grads in sides.items():
            err = float((grads[name].double() - g64).abs().max())
            noise[side] = max(noise[side], err / ref)
            assert err <= GRAD_NOISE * ref, (side, name, err, ref)
        apart = torch.sign(sides["port"][name]) != torch.sign(
            sides["jax"][name])
        flipped += int(apart.sum())
        if apart.any():
            assert float(g64[apart].abs().max()) <= GRAD_NOISE * ref, name
    trn = abs(got["records"]["trn_losses"][0] / np.mean(want["steps"]) - 1)
    val = abs(got["records"]["val_losses"][0] / want["val"][0] - 1)
    print(f"first-step gradients against float64: port {noise['port']:.3e},"
          f" JAX {noise['jax']:.3e} of a tensor's largest entry; {flipped} "
          f"entries of opposite signs; Adam epoch's losses {trn:.3e} "
          f"(training) and {val:.3e} (validation) apart")
    np.testing.assert_allclose(
        got["records"]["trn_losses"], [np.mean(want["steps"])],
        rtol=ADAM_RTOL, err_msg=f"{flipped} entries moved apart")
    np.testing.assert_allclose(got["records"]["val_losses"],
                               want["val"][:1], rtol=ADAM_RTOL)


def test_checkpoint_serves_the_trainers_evaluation(strainer_run):
    got, _, root = strainer_run
    got = got["parity"]
    pred = PairPredictor.from_checkpoint(
        got["run_dir"], contact_maps=load_contact_store(
            root / "raw" / "bindingdb_c" / "protein_maps.npz"),
        device="cpu")
    served = pred.predict_pairs(got["test_pairs"])
    np.testing.assert_allclose(served, got["logits"].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_resume_equals_straight_through(strainer_run):
    got, _, _ = strainer_run
    straight, resumed = got["straight"], got["resumed"]
    assert resumed["run_dir"] == got["first"]["run_dir"]
    assert len(straight["records"]["val_losses"]) == 2
    assert resumed["records"] == straight["records"]
    for rank in range(2):
        for k, v in straight["params"][rank].items():
            assert torch.equal(resumed["params"][rank][k], v), k


def test_graph_ready_step_equals_the_eager_step(strainer_run):
    """An epoch whose every step and evaluation takes its inputs through
    static slots (the captured step's form, run eagerly here) trains the
    eager epoch's noise, losses and parameters, bitwise."""
    got, _, _ = strainer_run
    eager, slots = got["first"], got["slots"]
    assert slots["records"] == eager["records"]
    for rank in range(2):
        for k, v in eager["params"][rank].items():
            assert torch.equal(slots["params"][rank][k], v), k


# ------------------------------------------------------------- the CLI
@pytest.fixture
def one_thread(monkeypatch):
    """A CPU rank takes one thread (the test workers share the host)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _only_run(work, dataset):
    runs = [d for d in (work / f"log_{dataset}").iterdir() if d.is_dir()]
    assert len(runs) == 1
    return runs[0]


def test_cli_trains_with_two_shards(tmp_path, one_thread):
    root = dti_copy(tmp_path / "data", (20, 8, 8))
    work = tmp_path / "runs"
    argv = ["--dataset", "bindingdb_c", "--dataset_root", str(root),
            "--pro_shards", "2", "--work_dir", str(work)] + SMALL
    assert run.main(argv) is None
    run_dir = _only_run(work, "bindingdb_c")
    loss, test, val = final_line(run_dir)
    assert np.isfinite(loss["testloss"]) and "valauc" in val
    result = json.loads((run_dir / "result.json").read_text())
    assert len(result["kernel_launches_by_rank"]) == 2
    assert result["config"]["pro_shards"] == 2
    # gloo ranks on the CPU replay no graphs, and each says why
    assert result["step_graphs"] is False
    assert [g["step_graphs"] for g in result["step_graphs_by_rank"]] \
        == [False, False]
    assert all("CPU" in g["reason"] for g in result["step_graphs_by_rank"])
    # the best checkpoint, served dense, gives the final line's test loss
    pred = PairPredictor.from_checkpoint(
        run_dir, contact_maps=load_contact_store(
            root / "raw" / "bindingdb_c" / "protein_maps.npz"),
        device="cpu")
    rows = [ln.split() for ln in (root / "raw" / "bindingdb_c" / "test.txt")
            .read_text().splitlines()]
    logits = pred.predict_pairs([(r[0], r[1]) for r in rows])
    ok = ~np.isnan(logits).any(1)
    y = np.asarray([float(r[2]) for r in rows])[ok].astype(int)
    z = logits[ok].astype(np.float64)
    lse = np.log(np.exp(z - z.max(1, keepdims=True)).sum(1)) + z.max(1)
    ce = lse - z[np.arange(len(y)), y]
    assert float(ce.mean()) == pytest.approx(loss["testloss"], rel=1e-4)
    from glam_tpu_torch.train.metrics import binary_metrics
    score = np.exp(z[:, 1] - lse)
    assert binary_metrics(y, score)["auc"] == pytest.approx(test["auc"],
                                                            abs=1e-4)
    # the AutoML summary (EnsemblePredictor.from_runs's selection) takes it
    sel = select_top_runs(work / "log_bindingdb_c", "bindingdb_c", 1)
    assert [r["id"] for r in sel] == [run_dir.name]


def test_cli_ring_halo_with_pair_batch(tmp_path, one_thread):
    root = dti_copy(tmp_path / "data", (21, 7, 7))
    work = tmp_path / "runs"
    assert run.main(["--dataset", "bindingdb_c", "--dataset_root",
                     str(root), "--pro_shards", "2", "--halo", "ring",
                     "--pair_batch", "2", "--work_dir", str(work)]
                    + SMALL) is None
    run_dir = _only_run(work, "bindingdb_c")
    log = (run_dir / "log.txt").read_text()
    assert "pair_batch=2" in log
    loss, _, _ = final_line(run_dir)
    assert np.isfinite(loss["testloss"])
    result = json.loads((run_dir / "result.json").read_text())
    assert result["optimizer_steps"] == 11       # 21 pairs, 2 a step


def test_cli_screening_family(tmp_path, one_thread):
    work = tmp_path / "runs"
    assert run.main(["--dataset", "ALDH1", "--dataset_root",
                     str(scr_copy(tmp_path / "data")), "--pro_shards", "2",
                     "--halo", "auto", "--pair_batch", "4", "--work_dir",
                     str(work)] + SMALL) is None
    run_dir = _only_run(work, "ALDH1")
    assert "halo auto -> " in (run_dir / "log.txt").read_text()
    loss, test, val = final_line(run_dir)
    assert "bedroc" in test and "ef_001" in test and "valbedroc" in val
    assert np.isfinite(loss["testloss"])


@pytest.mark.parametrize("flags,message", [
    (["--dataset", "demo", "--loss", "bcel", "--pro_shards", "2"],
     "DTI datasets only"),
    (["--dataset", "bindingdb_c", "--pro_shards", "2", "--n_devices", "2"],
     "mutually exclusive"),
    (["--dataset", "bindingdb_c", "--pair_batch", "2"],
     "--pair_batch applies to --pro_shards runs only")])
def test_cli_errors_match_jax(tmp_path, flags, message):
    root = (_raw_copy(tmp_path / "data", "demo", 20) if "demo" in flags
            else DATA / "dti_demo")
    argv = flags + ["--dataset_root", str(root), "--platform", "cpu",
                    "--work_dir", str(tmp_path)]
    with pytest.raises(ValueError, match=message):
        run.main(argv)


def test_cli_ranks_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """Without ``--platform cpu`` the ranks run on the card: with none,
    the launcher raises before starting any."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--dataset", "bindingdb_c", "--dataset_root",
                  str(DATA / "dti_demo"), "--pro_shards", "2",
                  "--work_dir", str(tmp_path)])


# ------------------------------------------------------ solver and model
def _trial_argv(GLAM, monkeypatch, tmp_path):
    solver = GLAM(dataset="bindingdb_c", dataset_root=str(DTI.parents[1]),
                  work_dir=str(tmp_path), pro_shards=4, halo="auto",
                  pair_batch=2, platform="cpu", n_init_configs=6,
                  n_low_fidelity_seed=1)
    captured = []

    class _Done:
        returncode = 0

        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    def fake_popen(argv, env=None):
        captured.append(list(argv))
        return _Done()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    if hasattr(solver, "_build_kernels"):
        solver._kernels_built = True
    solver.low_fidelity_training()
    return solver, captured


def test_solver_trials_match_jax(tmp_path, monkeypatch):
    from glam_tpu.automl.solver import GLAM as JaxGLAM
    from glam_tpu_torch.automl.solver import GLAM
    js, jargv = _trial_argv(JaxGLAM, monkeypatch, tmp_path / "jax")
    ps, pargv = _trial_argv(GLAM, monkeypatch, tmp_path / "port")
    assert ps.searched == js.searched and len(ps.searched) == 6
    assert len(pargv) == len(jargv) == 6
    for p, j in zip(pargv, jargv):
        i = p.index("--pro_shards")
        assert p[i:] == j[j.index("--pro_shards"):] == [
            "--pro_shards", "4", "--halo", "auto", "--pair_batch", "2"]
    from glam_tpu_torch.train.sharded_pair_trainer import sharded_config_ok
    from glam_tpu.train.sharded_pair_trainer import \
        sharded_config_ok as jax_ok
    for cfg in ({"graph_norm": "_BatchNorm"}, {"pre_norm": "_BatchNorm"},
                {"flat_norm": "_LayerNorm"}, {}):
        assert sharded_config_ok(cfg) == jax_ok(cfg)


def test_bench_analytic_matches_jax():
    want = jax_bench.analytic()
    got = bench_scaling.analytic(link_bytes_per_sec=4.5e10,
                                 flops_per_sec=1.0e13)
    rename = {"ici_bytes_per_shard_step": "link_bytes_per_shard_step",
              "ring_ici_bytes_per_shard_step":
                  "ring_link_bytes_per_shard_step"}
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == {rename.get(k, k) for k in w}
        for k, v in w.items():
            x = g[rename.get(k, k)]
            if isinstance(v, float):
                decimals = 2 if k.endswith("_us") else 4
                assert round(x, decimals) == v, k
            else:
                assert x == v, k
