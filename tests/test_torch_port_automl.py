"""The port's AutoML solver against the JAX package, on the CPU: the
search spaces and trial commands, the log summary and run selection,
the blenders, the trial scheduler, blending of trained runs,
``EnsemblePredictor``, the atomic dataset caches and the run directories
of trials started together, and one whole ``GLAM(platform="cpu")``
search.

Tolerances, each with its reason: samplers, ids, ranks and selected runs
exact (the same ``random.Random`` draws, the same sort keys); summary
statistics 1e-12 (float64 sums in another order than pandas'); blends
1e-12 (float64 metrics of the same arrays); ``EnsemblePredictor`` 1e-6
(a float32 mean over two models' outputs)."""
import ast
import csv
import json
import math
import os
import random
import threading
from pathlib import Path

import numpy as np
import pytest

from glam_tpu.automl import ensemble as jax_ensemble
from glam_tpu.automl import search_space as jax_space
from glam_tpu.automl import summary as jax_summary
from glam_tpu_torch import run as port_run
from glam_tpu_torch.automl import ensemble as port_ensemble
from glam_tpu_torch.automl import scheduler as port_scheduler
from glam_tpu_torch.automl import search_space as port_space
from glam_tpu_torch.automl import summary as port_summary
from glam_tpu_torch.automl.solver import GLAM
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.serve import EnsemblePredictor, Predictor
from glam_tpu_torch.train import metrics as port_metrics
from glam_tpu_torch.train import trainer as port_trainer
from glam_tpu_torch.train.pair_trainer import make_auto_trainer

DATASETS = Path(__file__).resolve().parents[1] / "datasets"


# ------------------------------------------------------------- samplers
@pytest.mark.parametrize("dataset", ["demo", "esol", "drugbank_caster",
                                     "bindingdb_c", "ALDH1"])
def test_sampler_matches_jax(dataset):
    """200 draws of the single-graph (classification and regression), DDI,
    DTI and screening spaces: the same configs and ids from the same
    random.Random, and the same trial argv apart from the module."""
    rj, rp = random.Random(7), random.Random(7)
    for i in range(200):
        cj, ij = jax_space.sample_config(dataset, "./d", 12, 1234, rj)
        cp, ip = port_space.sample_config(dataset, "./d", 12, 1234, rp)
        assert cp == cj and ip == ij, i
        cp["note"], cp["gpu"], cp["platform"] = ip, 0, None
        cj.update(note=ij, gpu=0, platform=None)
        argv_j, argv_p = jax_space.config2cmd(cj), port_space.config2cmd(cp)
        assert argv_j[:2] == ["-m", "glam_tpu.run"]
        assert argv_p[:2] == ["-m", "glam_tpu_torch.run"]
        assert argv_p[2:] == argv_j[2:]
        parsed = port_run.build_parser().parse_args(argv_p[2:])
        assert parsed.mol_block == cp["mol_block"] and parsed.lr == cp["lr"]
    assert port_space.MOL_BLOCKS == jax_space.MOL_BLOCKS
    assert port_space.READOUTS == jax_space.READOUTS
    assert port_space._CLI_FLAGS == jax_space._CLI_FLAGS


# -------------------------------------------------------------- summary
def _write_run(logs_dir, name, config, final):
    d = logs_dir / name
    d.mkdir(parents=True)
    lines = ["Training start...", "Epoch:0 ..."]
    if config is not None:
        lines.append(str(config))
    if final is not None:
        lines.append(final)
    (d / "log.txt").write_text("\n".join(lines) + "\n")


def _synthetic_logs(logs_dir):
    """4 configs x 3 seeds, one unfinished run and one with an inf
    metric; every metric value distinct."""
    rng = np.random.RandomState(0)
    for c in range(4):
        for j, seed in enumerate((12, 123, 1234)):
            cfg = {"dataset": "demo", "note": f"c{c}x", "seed": seed,
                   "epochs": 30, "batch_size": 32 * (c + 1),
                   "mol_block": "_NNConv", "optim": "Adam",
                   "lr": 10.0 ** -(c + 2), "e_dim": 256}
            vals = rng.rand(6)
            final = (f"{{'testloss': {vals[0]}, 'valloss': {vals[1]}}}|"
                     f"{{'auc': {vals[2]}, 'acc': {vals[3]}}}|"
                     f"{{'valauc': {vals[4]}, 'valacc': {vals[5]}}}")
            _write_run(logs_dir, f"2026-01-0{c + 1}_00:00:0{j}.000_seed_"
                       f"{seed}", cfg, final)
    _write_run(logs_dir, "2026-01-09_00:00:00.000_seed_12", None, None)
    cfg = {"dataset": "demo", "note": "c9x", "seed": 12}
    _write_run(logs_dir, "2026-01-09_00:00:01.000_seed_12", cfg,
               "{'testloss': inf, 'valloss': 0.4}|{'auc': 0.9}|"
               "{'valauc': 0.9}")


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_cell(got, want):
    if want == "" or got == "":
        assert got == want
        return
    try:
        assert float(got) == pytest.approx(float(want), rel=1e-12,
                                           abs=1e-12)
    except ValueError:
        assert got == want


def test_summary_and_selection_match_jax(tmp_path):
    jdir, pdir = tmp_path / "j" / "log_demo", tmp_path / "p" / "log_demo"
    _synthetic_logs(jdir)
    _synthetic_logs(pdir)
    logs_j = jax_summary.read_logs(jdir)
    logs_p = port_summary.read_logs(pdir)
    assert logs_p == logs_j and len(logs_p) == 12

    want = jax_summary.auto_summarize_logs("demo", jdir.parent)
    got = port_summary.auto_summarize_logs("demo", pdir.parent)
    assert [r["note"] for r in got] == list(want["note"])
    assert [r["config"] for r in got] == list(want["config"])
    assert list(got[0]) == list(want.columns)
    for r, (_, w) in zip(got, want.iterrows()):
        for col in want.columns:
            if col in ("note", "config"):
                continue
            assert r[col] == pytest.approx(w[col], rel=1e-12, abs=1e-12), \
                col
    assert got[0]["seed_std"] == pytest.approx(
        np.std([12, 123, 1234], ddof=1), rel=1e-12)
    for name in ("logs_summary.csv", "search_result.csv"):
        rows_j, rows_p = _csv_rows(jdir / name), _csv_rows(pdir / name)
        assert rows_p[0] == rows_j[0], name
        assert len(rows_p) == len(rows_j)
        for a, b in zip(rows_p[1:], rows_j[1:]):
            for x, y in zip(a, b):
                _same_cell(x, y)

    for n in (1, 3, 20):
        sel_j = jax_summary.select_top_runs(jdir, "demo", n)
        sel_p = port_summary.select_top_runs(pdir, "demo", n)
        assert [r["id"] for r in sel_p] == list(sel_j["id"])
        assert [r["config"] for r in sel_p] == list(sel_j["config"])
        assert _csv_rows(pdir / "inf_ckpt_selected.csv") == \
            _csv_rows(jdir / "inf_ckpt_selected.csv")
    assert port_summary.print_ongoing_info(pdir) == \
        jax_summary.print_ongoing_info(jdir)


def test_summary_of_a_single_seed_and_of_ties(tmp_path):
    """A group of one has NaN std (an empty CSV cell); tied metrics keep
    their order, group keys ascending and runs as read (a stable sort;
    pandas' sort is not stable for ties, ROADMAP §C); the DDI
    multiclass logs without valauc rank by valacc."""
    logs_dir = tmp_path / "log_demo"
    for i, note in enumerate(("b", "a", "c")):
        cfg = {"dataset": "demo", "note": note, "seed": 1}
        _write_run(logs_dir, f"r{i}_seed_1", cfg,
                   "{'testloss': 0.5}|{'auc': 0.5}|{'valauc': 0.7}")
    summary = port_summary.summarize_logs(
        port_summary.read_logs(logs_dir), "demo", logs_dir)
    assert [r["note"] for r in summary] == ["a", "b", "c"]
    assert math.isnan(summary[0]["valauc_std"])
    rows = _csv_rows(logs_dir / "logs_summary.csv")
    assert rows[1][rows[0].index("valauc_std")] == ""
    sel = port_summary.select_top_runs(logs_dir, "demo", 3)
    assert [r["id"] for r in sel] == ["r0_seed_1", "r1_seed_1", "r2_seed_1"]
    ddi = tmp_path / "log_drugbank_caster"
    for i, acc in enumerate((0.2, 0.6)):
        _write_run(ddi, f"r{i}_seed_1", {"note": "x", "seed": 1},
                   f"{{'testloss': 0.5}}|{{'acc': 0.5}}|{{'valacc': {acc}}}")
    assert [r["id"] for r in port_summary.select_top_runs(
        ddi, "drugbank_caster", 1)] == ["r1_seed_1"]


# -------------------------------------------------------------- blending
def _outputs(task, rng, n=40, runs=3):
    out = []
    y_cls = rng.randint(0, 2, n).astype(float)
    y_mt = rng.randint(-1, 2, (n, 3)).astype(float)
    y_mc = rng.randint(0, 4, n).astype(float)
    y_reg = rng.randn(n)
    for _ in range(runs):
        if task in ("regression", "pair_regression"):
            out.append((y_reg, rng.randn(n)))
        elif task == "pair_binary_bce":
            out.append((rng.rand(n), y_cls))
        elif task == "pair_multiclass":
            prob = rng.dirichlet(np.ones(4), n)
            out.append((y_mc, prob.argmax(-1), prob))
        elif task in ("pair_binary", "pair_screening"):
            out.append((y_cls, rng.randint(0, 2, n), rng.rand(n)))
        else:                                   # 1gp multi-task
            out.append((rng.rand(n, 3), y_mt))
    return out


@pytest.mark.parametrize("task,return_pred", [
    ("regression", False), ("regression", True), ("pair_regression", False),
    ("pair_binary_bce", False), ("pair_multiclass", False),
    ("pair_binary", False), ("pair_screening", False),
    ("binary_nan_bce", False)])
def test_blend_outputs_match_jax(task, return_pred):
    for runs in (2, 3):      # 2 runs: the vote's ties go to label 0
        outputs = _outputs(task, np.random.RandomState(runs), runs=runs)
        got = port_ensemble._blend_outputs(task, "x", outputs, return_pred)
        want = jax_ensemble._blend_outputs(task, "x", outputs, return_pred)
        if return_pred:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
            continue
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-12,
                                           abs=1e-12, nan_ok=True), k


def test_vote_ties_go_to_the_smallest_label():
    y = np.asarray([0.0, 1.0, 1.0, 0.0])
    outs = [(y, np.asarray([1, 0, 1, 1]), np.full(4, 0.5)),
            (y, np.asarray([0, 1, 1, 1]), np.full(4, 0.5))]
    got = port_metrics.blend_binary_classification(
        outs, metrics_fn=lambda t, y_score, y_pred: y_pred.tolist())
    assert got == [0, 0, 1, 1]


# ------------------------------------------------------------- scheduler
class _Proc:
    def __init__(self, polls_left=None):
        self.polls_left = polls_left      # None: runs until .done is set
        self.done = False

    def poll(self):
        if self.polls_left is not None:
            self.polls_left -= 1
            self.done = self.polls_left <= 0
        return 0 if self.done else None


def test_device_manager_slots_and_cards(monkeypatch):
    monkeypatch.delenv("GLAM_TPU_TRIAL_SLOTS", raising=False)
    dm = port_scheduler.DeviceManager(num_cards=2, poll_interval=0.01)
    assert dm.num_slots == 2
    assert port_scheduler.DeviceManager(num_cards=0).num_slots == 1
    assert port_scheduler.DeviceManager(num_cards=0).card(3) == 0
    monkeypatch.setenv("GLAM_TPU_TRIAL_SLOTS", "4")
    dm = port_scheduler.DeviceManager(num_cards=1, poll_interval=0.01)
    assert dm.num_slots == 4 and [dm.card(s) for s in range(4)] == [0] * 4
    dm = port_scheduler.DeviceManager(num_cards=3, poll_interval=0.01)
    assert [dm.card(s) for s in range(4)] == [0, 1, 2, 0]

    # wait_free_slot returns once one of num_slots running trials exits
    dm = port_scheduler.DeviceManager(num_slots=2, num_cards=1,
                                      poll_interval=0.01)
    procs = [_Proc(3), _Proc()]
    dm.wait_free_slot(procs)
    assert dm.running(procs) == 1
    # wait_free_device hands out distinct slots, and a slot again once
    # its trial has exited
    slot_procs = {}
    s0 = dm.wait_free_device(slot_procs)
    slot_procs[s0] = _Proc()
    s1 = dm.wait_free_device(slot_procs)
    slot_procs[s1] = _Proc()
    assert {s0, s1} == {0, 1}
    timer = threading.Timer(0.05, lambda: setattr(slot_procs[s1], "done",
                                                  True))
    timer.start()
    assert dm.wait_free_device(slot_procs) == s1
    timer.join(timeout=5)
    assert not timer.is_alive()


def test_glam_cli_parser_matches_jax():
    from glam_tpu.glam import build_parser as jax_parser
    from glam_tpu_torch.glam import build_parser
    want = {a.dest: (a.default, a.type) for a in jax_parser()._actions}
    assert {a.dest: (a.default, a.type)
            for a in build_parser()._actions} == want


def test_solver_options_fail_early(tmp_path):
    kw = dict(dataset="demo", dataset_root=str(tmp_path),
              work_dir=str(tmp_path), platform="cpu")
    # the sharded trials take their halo plan and pair batch
    solver = GLAM(pro_shards=2, halo="ring", pair_batch=2, **kw)
    assert (solver.pro_shards, solver.halo, solver.pair_batch) == \
        (2, "ring", 2)
    with pytest.raises(ValueError, match="pro_shards"):
        GLAM(halo="ring", **kw)
    with pytest.raises(ValueError, match="pro_shards"):
        GLAM(pair_batch=2, **kw)
    with pytest.raises(ValueError, match="platform"):
        GLAM(**dict(kw, platform="tpu"))


# -------------------------------------------------- atomic dataset caches
def _demo_root(tmp_path, n):
    root = tmp_path / "demo"
    (root / "raw").mkdir(parents=True)
    lines = (DATASETS / "demo" / "raw" / "demo.csv").read_text() \
        .splitlines()[:n + 1]
    (root / "raw" / "demo.csv").write_text("\n".join(lines) + "\n")
    return root


def _graphs_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        for f in ("nodes", "edges", "senders", "receivers", "y"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
        assert ga.smi == gb.smi


def test_half_written_cache_is_never_read(tmp_path):
    """A cache and a split file cut in half at their final paths (left by
    a writer that wrote in place) are rebuilt, not read; a writer that
    fails mid-save leaves neither a file at the final path nor its
    temporary file."""
    root = _demo_root(tmp_path, 60)
    whole = port_datasets.MolDataset(str(root), "demo")
    cache = root / "processed" / "dataset_demo.npz"
    split = root / "processed" / "split_1234_demo_random.npz"
    for path in (cache, split):
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    again = port_datasets.MolDataset(str(root), "demo")
    _graphs_equal(again.graphs, whole.graphs)
    _graphs_equal(again.train, whole.train)
    _graphs_equal(port_datasets.load_graph_cache(cache), whole.graphs)

    def half_then_fail(f, **arrays):
        f.write(b"PK\x03\x04 half an archive")
        raise OSError("disk full")

    target = root / "processed" / "other.npz"
    with pytest.raises(OSError, match="disk full"):
        port_datasets.save_npz_atomic(target, half_then_fail,
                                      x=np.zeros(3))
    assert sorted(p.name for p in (root / "processed").iterdir()) == \
        sorted([cache.name, split.name])


def test_concurrent_first_loads_agree(tmp_path):
    """Eight loaders started together on a fresh root (as the trials of a
    search are): every one gets whole graphs and splits."""
    root = _demo_root(tmp_path, 150)
    results, errors = [None] * 8, []

    def load(i):
        try:
            results[i] = port_datasets.MolDataset(str(root), "demo")
        except Exception as err:   # noqa: BLE001 - reported below
            errors.append(repr(err))

    threads = [threading.Thread(target=load, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for ds in results[1:]:
        _graphs_equal(ds.graphs, results[0].graphs)
        _graphs_equal(ds.test, results[0].test)
    assert not [p for p in (root / "processed").iterdir()
                if p.name.startswith(".")]


def test_trainers_started_together_get_their_own_run_dirs(tmp_path,
                                                         monkeypatch):
    """Two trials that draw one millisecond's run id do not share its
    directory: the later takes the next id; sixteen threads making run
    directories at once all get their own."""
    ids = iter(["2026-01-01_00:00:00.000_seed_1"] * 2
               + ["2026-01-01_00:00:00.001_seed_1"])
    with monkeypatch.context() as m:
        m.setattr(port_trainer, "_utc_run_id", lambda seed: next(ids))
        a = port_trainer._new_run_dir(tmp_path / "log_demo", 1)
        b = port_trainer._new_run_dir(tmp_path / "log_demo", 1)
    assert a[0] == "2026-01-01_00:00:00.000_seed_1"
    assert b == ("2026-01-01_00:00:00.001_seed_1",
                 tmp_path / "log_demo" / "2026-01-01_00:00:00.001_seed_1")
    made = []
    threads = [threading.Thread(target=lambda: made.append(
        port_trainer._new_run_dir(tmp_path / "log_x", 12)[0]))
        for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(set(made)) == 16


# -------------------------------------------- blending of trained runs
SMALL = {"epochs": 1, "batch_size": 32, "e_dim": 32, "hid_dim_alpha": 1,
         "message_steps": 1, "optim": "Adam", "lr": 1e-3,
         "mol_block": "_TripletMessage", "note": "n"}


def _train_runs(args, work_dir, seeds):
    """One-epoch port runs on the CPU; each run's inference outputs on
    its test set from its best checkpoint."""
    outs = []
    for seed in seeds:
        a, ds, kind = port_datasets.auto_dataset(dict(args, seed=seed))
        tr = make_auto_trainer(a, ds, kind, work_dir=str(work_dir),
                               device="cpu")
        tr.train_and_test()
        outs.append(tr.valid_iterations(mode="inference"))
    return outs


@pytest.mark.parametrize("family", ["demo", "ddi"])
def test_blend_of_trained_runs_equals_the_mean_of_their_outputs(
        tmp_path, family):
    if family == "demo":
        root = _demo_root(tmp_path, 120)
        args = dict(SMALL, dataset="demo", dataset_root=str(root),
                    loss="bcel")
        metric = port_metrics.binary_metrics_multi_target_nan
    else:
        args = dict(SMALL, dataset="drugbank_caster",
                    dataset_root=str(DATASETS / "ddi_demo"))
        metric = port_metrics.binary_metrics
    work = tmp_path / "work"
    outs = _train_runs(args, work, (3, 4))
    want = metric(outs[0][1], np.mean([o[0] for o in outs], axis=0))
    logs_dir = work / f"log_{args['dataset']}"
    sel = port_summary.select_top_runs(logs_dir, args["dataset"], 2)
    got = port_ensemble.blend_and_inference(
        [r["id"] for r in sel], [r["config"] for r in sel], work,
        log=lambda *_: None, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    # the rebuilt trainers left no run directories behind
    assert len([p for p in logs_dir.iterdir() if p.is_dir()]) == 2
    if family == "demo":
        ens = EnsemblePredictor.from_runs(logs_dir, n=2, device="cpu")
        smis = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "xyz"]
        single = [Predictor.from_checkpoint(logs_dir / r["id"],
                                            device="cpu") for r in sel]
        for fn in ("predict_scores", "predict_smiles"):
            got = getattr(ens, fn)(smis)
            want = np.mean([getattr(p, fn)(smis) for p in single], axis=0)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            assert np.isnan(got[3]).all() and np.isfinite(got[:3]).all()


# ------------------------------------------------------- a whole search
def test_glam_search_on_the_cpu(tmp_path, monkeypatch):
    """GLAM(platform="cpu") on 150 demo molecules: 2 configs x 1 seed x 1
    epoch, then the top one x 1 seed x 1 epoch, then the blend of the
    top run; every trial exits 0 and writes its final line."""
    monkeypatch.setenv("GLAM_TPU_TRIAL_SLOTS", "2")
    root = _demo_root(tmp_path, 150)
    # two trials at once beside the other test workers: two threads each
    env = dict(os.environ, OMP_NUM_THREADS="2")
    solver = GLAM("demo", str(root), n_init_configs=2,
                  n_low_fidelity_seed=1, n_top_blend=1,
                  n_high_fidelity_seed=1, seed=1, work_dir=str(tmp_path),
                  env=env, low_fidelity_epochs=1, high_fidelity_epochs=1,
                  platform="cpu")
    assert solver.dm.num_slots == 2 and solver.device == "cpu"
    solver.low_fidelity_training()
    result = solver.auto_blend()
    assert solver.failed_trials == 0 and len(solver.trials) == 3
    assert all(t["proc"].returncode == 0 and t["seconds"] > 0
               for t in solver.trials)
    logs = port_summary.read_logs(solver.logs_dir)
    assert len(logs) == 3
    assert sorted(r["note"] for r in logs)[-1] == "more_epochs_run"
    for r in logs:
        assert ast.literal_eval(r["config"])["platform"] == "cpu"
    for name in ("logs_summary.csv", "search_result.csv",
                 "inf_ckpt_selected.csv", "solver_log.txt"):
        assert (solver.logs_dir / name).is_file(), name
    # summarised before the high-fidelity rerun: the two searched runs
    assert len(_csv_rows(solver.logs_dir / "search_result.csv")) == 3
    assert result.keys() == {"auc", "acc", "precision", "recall"}
    assert all(math.isfinite(v) for v in result.values())
    runs = [p for p in solver.logs_dir.iterdir() if p.is_dir()]
    assert len(runs) == 3 and all((p / "best_save.pt").is_file()
                                  for p in runs)
    record = json.loads((runs[0] / "result.json").read_text())
    assert record["config"]["platform"] == "cpu"
