"""Data parallelism in the port (``glam_tpu_torch.parallel``, the
trainers' ``--n_devices``) against the JAX package, on the CPU.

  * the loaders: rank k's sub-batch of each global batch equals the JAX
    loader's device-stacked batch at [k] (exact), for D = 2 and 4, with
    trailing all-padding sub-batches, for ``GraphLoader`` and
    ``PairGraphLoader``; an indivisible batch raises;
  * the weight functions equal the JAX trainers' (exact);
  * one spawn of 2 gloo ranks (``tests/torch_port_dp_worker.py``, in the
    manner of ``tests/test_distributed_multiprocess.py``) from the JAX
    ``Trainer(n_devices=2)``'s initial weights, carried across by
    ``convert``:
      - one SGD step's parameters against the port's single-process step
        of the global batch (rtol 1e-5, atol 1e-7: the sums over ranks
        run in another order) and against the JAX trainer's data-parallel
        step (rtol 1e-4, atol 1e-6 x each tensor's scale: two frameworks'
        float32 kernels);
      - the merged evaluation's outputs and loss against one process
        (1e-6);
      - BatchNorm's running statistics after the step
        (``light_set2set_bn``) against JAX's ``pmean`` (1e-5);
      - a 1-epoch DDI pair trainer's losses against the JAX
        data-parallel pair trainer's (rtol 1e-4);
      - ``process_shard``, ``global_mesh``, the backend rule and
        ``bench_scaling.measure(2, graphs_per_device=8, n_iter=2)``;
      - one collective (a ``torch.distributed`` call) a training step
        and one an evaluation step, what lets a replayed step hold its
        all-reduce (nccl) or sit around one (gloo);
      - a parameter no rank reaches keeps no gradient, and Adam leaves
        it and its state alone;
  * the step graphs' rule: none on the CPU, the whole step's graph under
    nccl, two graphs around an eager all-reduce under gloo, and node-
    sharded steps eager under gloo;
  * ``initialize_distributed`` reads the ``GLAM_*`` variables, and
    ``host_groups`` partitions devices.
"""
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import graphs_from_smiles
from glam_tpu.data import pair_datasets as jax_pairs
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.data.batching import PairGraphLoader as JaxPairLoader
from glam_tpu.nn import model as jax_model
from glam_tpu.train import pair_trainer as jax_pair_trainer
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert
from glam_tpu_torch.data.batching import GraphLoader, PairGraphLoader
from glam_tpu_torch.data.graph import GraphArrays
from glam_tpu_torch.parallel import distributed
from glam_tpu_torch.train import pair_trainer as port_pair_trainer
from glam_tpu_torch.train import trainer as port_trainer
from test_torch_port_model import _np_tree
from test_torch_port_train import TRAIN_ARGS, _record_losses

import torch_port_dp_worker as worker
from torch_port_dp_worker import spawn_ranks, wait_ranks

REPO = Path(__file__).resolve().parents[1]
DDI_CSV = REPO / "datasets" / "ddi_demo" / "raw" / "drugbank_caster.csv"
FIELDS = ("nodes", "edges", "senders", "receivers", "node_graph", "node_pos",
          "n_node", "node_mask", "edge_mask", "graph_mask", "y")


def _jax_graphs(n, seed=0):
    smis = [worker.SMILES[i % len(worker.SMILES)] for i in range(n)]
    return graphs_from_smiles(smis, ys=np.random.RandomState(seed).randn(n))


def _port(gs):
    return [GraphArrays(*g) for g in gs]


def _same(port_batch, jax_batch, k):
    for f in FIELDS:
        want = np.asarray(getattr(jax_batch, f))[k]
        got = getattr(port_batch, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f)


# ---------------------------------------------------------------- loaders
@pytest.mark.parametrize("D", [2, 4])
def test_graph_loader_ranks_equal_jax_stacked(D):
    """10 graphs, global batch 8: the second global batch's 2 graphs fall
    on rank 0, ranks 1..D-1 get all-padding sub-batches."""
    gs = _jax_graphs(10)
    for shuffle in (False, True):
        want = list(JaxLoader(gs, 8, 1, shuffle=shuffle, seed=5,
                              n_devices=D))
        got = [list(GraphLoader(_port(gs), 8, 1, shuffle=shuffle, seed=5,
                                n_devices=D, rank=k)) for k in range(D)]
        assert all(len(g) == len(want) == 2 for g in got)
        for b, jb in enumerate(want):
            for k in range(D):
                _same(got[k][b], jb, k)
        assert int(got[0][1].graph_mask.sum()) == 2
        assert not any(bool(got[k][1].graph_mask.any())
                       for k in range(1, D))


@pytest.mark.parametrize("D", [2, 4])
def test_pair_loader_ranks_equal_jax_stacked(D):
    gs = _jax_graphs(12)
    pairs = [(gs[i], gs[(i * 5 + 1) % 12]) for i in range(10)]
    port_pairs = [tuple(_port(p)) for p in pairs]
    want = list(JaxPairLoader(pairs, 8, 1, shuffle=True, seed=2,
                              n_devices=D))
    got = [list(PairGraphLoader(port_pairs, 8, 1, shuffle=True, seed=2,
                                n_devices=D, rank=k)) for k in range(D)]
    for b, (j1, j2) in enumerate(want):
        for k in range(D):
            _same(got[k][b][0], j1, k)
            _same(got[k][b][1], j2, k)
    assert not any(bool(got[k][1][0].graph_mask.any()) for k in range(1, D))


def test_indivisible_batch_raises():
    gs = _port(_jax_graphs(8))
    with pytest.raises(ValueError, match="not divisible"):
        GraphLoader(gs, 6, 1, n_devices=4, rank=0)
    with pytest.raises(ValueError, match="not divisible"):
        PairGraphLoader(list(zip(gs, gs)), 6, 1, n_devices=4, rank=1)
    with pytest.raises(ValueError, match="rank"):
        GraphLoader(gs, 8, 1, n_devices=2, rank=2)


# ---------------------------------------------------------------- weights
def _labelled_batch():
    gs = _jax_graphs(7)
    jb = next(iter(JaxLoader(gs, 8, 3)))
    y = np.random.RandomState(4).randint(-1, 2, jb.y.shape).astype(
        np.float32)
    return y, np.asarray(jb.graph_mask)


@pytest.mark.parametrize("task", ["regression", "binary_nan",
                                  "binary_nan_bce"])
def test_weight_fn_matches_jax(task):
    y, gmask = _labelled_batch()
    want = float(jax_trainer.make_weight_fn(task)(jnp.asarray(y),
                                                  jnp.asarray(gmask)))
    got = float(port_trainer.make_weight_fn(task)(torch.from_numpy(y),
                                                  torch.from_numpy(gmask)))
    assert got == want


@pytest.mark.parametrize("task,loss", [("pair_screening", "wce"),
                                       ("pair_binary", "wce"),
                                       ("pair_binary", "ce"),
                                       ("pair_binary_bce", "bcel")])
def test_pair_weight_matches_jax(task, loss):
    """wce's weight is the class weights of the real pairs' targets
    summed; the others count real pairs."""
    y, gmask = _labelled_batch()
    y = y[:, :1]
    cw = [0.3, 2.5]
    fake = types.SimpleNamespace(args={"loss": loss}, task=task,
                                 class_weights=cw, device="cpu")
    want = float(jax_pair_trainer.PairTrainer._make_weight(fake)(
        jnp.asarray(y), jnp.asarray(gmask)))
    got = float(port_pair_trainer.PairTrainer._make_weight(fake)(
        torch.from_numpy(y), torch.from_numpy(gmask)))
    assert got == pytest.approx(want, rel=1e-7)


# ---------------------------------------------------- distributed helpers
def test_initialize_distributed_reads_the_glam_variables(monkeypatch):
    seen = {}

    def fake_init(backend, init_method, world_size, rank, timeout):
        seen.update(backend=backend, init_method=init_method,
                    world_size=world_size, rank=rank)

    monkeypatch.setattr(distributed.dist, "init_process_group", fake_init)
    monkeypatch.setenv("GLAM_COORDINATOR", "127.0.0.1:4321")
    monkeypatch.setenv("GLAM_NUM_PROCESSES", "4")
    monkeypatch.setenv("GLAM_PROCESS_ID", "0")      # rank 0 is not missing
    assert distributed.initialize_distributed(platform="cpu") == "gloo"
    assert seen == {"backend": "gloo", "init_method": "tcp://127.0.0.1:4321",
                    "world_size": 4, "rank": 0}
    monkeypatch.delenv("GLAM_COORDINATOR")
    with pytest.raises(ValueError, match="GLAM_COORDINATOR"):
        distributed.initialize_distributed(platform="cpu")


@pytest.mark.parametrize("where,want", [
    (("cpu", 2, 0), ("gloo", None, None)),
    (("cuda", 2, 1), ("gloo", "segmented", None)),
    (("cuda", 4, 1), ("gloo", "segmented", None)),
    (("cuda", 4, 4), ("nccl", "whole", "whole")),
    (("cuda", 2, 8), ("nccl", "whole", "whole"))])
def test_step_graph_rule(where, want):
    """A rank's step graphs follow its backend alone, and say why."""
    backend, design, why = distributed.step_graphs_rule(*where)
    sharded, sharded_why = distributed.sharded_step_graphs_for(
        backend, where[0])
    assert (backend, design, sharded) == want
    assert why and sharded_why
    if where[0] == "cpu":
        assert "CPU" in why and "CPU" in sharded_why
    elif backend == "gloo":
        assert "host" in why and "eager" in sharded_why
    else:
        assert distributed.CAPTURE_ERROR_MODE[backend] == "thread_local"


def test_backend_rule_and_host_groups():
    assert distributed.backend_for("cpu", 2, 0)[0] == "gloo"
    assert distributed.backend_for("cuda", 2, 1)[0] == "gloo"
    assert distributed.backend_for("cuda", 4, 4)[0] == "nccl"
    devs = [f"d{i}" for i in range(8)]
    assert distributed.host_groups(4, devs) == [devs[0:2], devs[2:4],
                                                devs[4:6], devs[6:8]]
    with pytest.raises(ValueError):
        distributed.host_groups(9, devs)
    assert distributed.process_shard(list(range(7)), 1, 3) == [1, 4]


# -------------------------------------------------- two ranks, one spawn
def _jax_trainer(name, n_devices, tmp):
    args, _ = worker.config_args(name, n_devices)
    args["scan_steps"] = 1
    jcfg = jax_model.model_config_from_args(args, mol_in_dim=15,
                                            mol_edge_in_dim=4, out_dim=1,
                                            max_nodes=32)
    return jax_trainer.Trainer(args, jax_model.Architecture(jcfg),
                               _jax_graphs(worker.N_TRAIN),
                               _jax_graphs(worker.N_VALID, seed=1),
                               print_log=False,
                               work_dir=str(tmp / f"jax_{name}"))


def _port_state(tj, cfg, pair=None):
    stats = tj.state.batch_stats
    return convert.state_dict_from_jax(
        _np_tree(tj.state.params), cfg, _np_tree(stats) if stats else None,
        pair=pair)


def _ddi_args(root):
    return dict(TRAIN_ARGS, dataset="drugbank_caster", dataset_root=root,
                end_act="CELU", epochs=1, e_dim=32, message_steps=2)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX trainers at n_devices=2 and their initial weights; the two
    gloo ranks' run from them; meanwhile the JAX data-parallel steps, the
    port's single-process steps and the JAX DDI epoch."""
    work = tmp_path_factory.mktemp("dp")
    root = work / "ddi"
    (root / "raw").mkdir(parents=True)
    lines = DDI_CSV.read_text().splitlines(keepends=True)[:101]
    (root / "raw" / "drugbank_caster.csv").write_text("".join(lines))
    jt = {name: _jax_trainer(name, 2, work) for name in worker.CONFIGS}
    for name, tj in jt.items():
        torch.save(_port_state(tj, worker.config_args(name, 2)[1]),
                   work / f"init_{name}.pt")
    ddi_args = _ddi_args(str(root))
    jddi = jax_pair_trainer.make_ddi_trainer(
        dict(ddi_args, n_devices=2, scan_steps=1),
        jax_pairs.DDIDataset(str(root)), work_dir=str(work / "jax_ddi"))
    torch.save(convert.state_dict_from_jax(
        _np_tree(jddi.state.params), convert.config_from_args(jddi.args),
        pair="homo"), work / "init_ddi.pt")
    (work / "plan.json").write_text(json.dumps({
        "tasks": ["step", "ddi", "dist", "measure", "partial"],
        "platform": "cpu",
        "ddi_root": str(root), "ddi_args": ddi_args}))
    procs = spawn_ranks(work, "cpu")
    # meanwhile: the JAX data-parallel step, the port in one process
    want = {}
    for name, tj in jt.items():
        batch = next(iter(tj.train_loader))
        tj.state, _ = tj._train_step(tj.state, tj._as_parts(batch),
                                     jax.random.PRNGKey(9))
        single = worker.trainer(name, 1, work, "cpu")
        want[name] = {"jax": _port_state(tj, single.model.cfg),
                      "single": worker.step_and_eval(single)}
    rec = _record_losses(jddi, True)
    jddi.train()
    want["ddi"] = rec
    return wait_ranks(procs, work), want


@pytest.mark.parametrize("name", ["flagship"])
def test_dp_step_matches_one_process(dp_run, name):
    """(BatchNorm normalises by each rank's own batch statistics, as the
    JAX package's data-parallel BatchNorm does, so the BatchNorm model is
    held against the JAX step below, not against one process.)"""
    got, want = dp_run
    got, single = got[f"step_{name}"]["state"], want[name]["single"]["state"]
    assert got.keys() == single.keys()
    for k in got:
        torch.testing.assert_close(got[k], single[k], rtol=1e-5, atol=1e-7,
                                   msg=k)


@pytest.mark.parametrize("name", list(worker.CONFIGS))
def test_dp_step_matches_jax(dp_run, name):
    got, want = dp_run
    got, jax_state = got[f"step_{name}"]["state"], want[name]["jax"]
    for k, w in jax_state.items():
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(got[k], w, rtol=1e-4, atol=1e-6 * scale,
                                   msg=k)


@pytest.mark.parametrize("name", list(worker.CONFIGS))
def test_dp_eval_merges_as_one_process(dp_run, name):
    got, want = dp_run
    got, single = got[f"step_{name}"], want[name]["single"]
    assert got["out"].shape == single["out"].shape == (worker.N_VALID, 1)
    np.testing.assert_allclose(got["out"], single["out"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got["y"], single["y"])
    assert got["loss"] == pytest.approx(single["loss"], rel=1e-6, abs=1e-7)


def test_dp_batchnorm_statistics_match_jax_pmean(dp_run):
    got, want = dp_run
    got = got["step_light_set2set_bn"]["state"]
    jax_state = want["light_set2set_bn"]["jax"]
    stats = [k for k in jax_state if k.endswith((".mean", ".var"))]
    assert len(stats) >= 4
    for k in stats:
        torch.testing.assert_close(got[k], jax_state[k], rtol=1e-5,
                                   atol=1e-5, msg=k)


def test_dp_ddi_epoch_matches_jax(dp_run):
    got, want = dp_run
    for key in ("trn", "val"):
        assert len(got["ddi"][key]) == len(want["ddi"][key]) == 1
        np.testing.assert_allclose(got["ddi"][key], want["ddi"][key],
                                   rtol=1e-4)


def test_dp_helpers_in_the_ranks(dp_run):
    got, _ = dp_run
    d = got["dist"]
    assert d["ranks"] == 2 and d["backend"] == "gloo"
    assert d["shards"] == [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]
    assert d["mesh"] == ["cpu", "cpu"]
    m = got["measure"]
    assert m["devices"] == 2 and m["platform"] == "cpu"
    assert m["edges_per_sec"] > 0 and m["step_ms"] > 0


def test_dp_step_takes_a_gradient_any_rank_has(dp_run):
    """Each layer has a gradient on one rank only: both ranks still take
    the summed gradient for it, so the replicas stay equal, and each
    layer moves as one process's SGD step on rank k's loss / 2."""
    got, _ = dp_run
    states = got["partial"]
    assert len(states) == 2
    want = worker.partial_model()
    x = torch.ones(4, 3)
    for layer in want:
        (layer(x) ** 2).mean().mul(0.5).backward()
    with torch.no_grad():
        for p in want.parameters():
            p -= 0.1 * p.grad
    init = worker.partial_model().state_dict()
    for k, w in want.state_dict().items():
        assert not torch.equal(w, init[k]), k
        for state in states:
            torch.testing.assert_close(state[k], w, rtol=1e-6, atol=1e-7,
                                       msg=k)


@pytest.mark.parametrize("name", list(worker.CONFIGS))
def test_dp_steps_make_one_collective(dp_run, name):
    """The weight W rides in the gradients' buffer, so a training step is
    one all-reduce; an evaluation step one of [w, loss w]."""
    got, want = dp_run
    assert got[f"step_{name}"]["collectives"] == {"train": 1, "eval": 1}
    assert want[name]["single"]["collectives"] == {"train": 0, "eval": 0}


def test_dp_untouched_parameter_keeps_no_gradient(dp_run):
    """Two Adam steps of three layers, rank k's forward reaching layer k
    alone: the step's gradient set holds the first two layers on both
    ranks, the third keeps ``grad None`` and no Adam state, and does not
    move; the replicas stay equal."""
    got, _ = dp_run
    ranks = got["partial_adam"]
    torch.manual_seed(1)
    init = torch.nn.ModuleList(torch.nn.Linear(3, 1) for _ in range(
        worker.PARTIAL_LAYERS + 1)).state_dict()
    last = f"{worker.PARTIAL_LAYERS}."
    for r in ranks:
        assert r["had"] == [True] * (2 * worker.PARTIAL_LAYERS) \
            + [False, False]
        assert r["untouched_grads"] == [True, True]
        assert r["untouched_adam_state"] == [0, 0]
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k
            assert torch.equal(v, init[k]) == k.startswith(last), k


# ------------------------------------------------------------------- CLI
def test_cli_two_ranks_on_the_cpu(tmp_path, capsys):
    """``run --n_devices 2 --platform cpu`` starts two gloo ranks of
    itself; rank 0 alone writes the run directory, the log's final line
    and result.json, which holds both ranks' kernel launches."""
    from glam_tpu_torch import run
    from test_torch_port_train import _raw_copy
    root = _raw_copy(tmp_path / "data", "demo", 40)
    argv = ["--dataset", "demo", "--dataset_root", str(root), "--loss",
            "bcel", "--platform", "cpu", "--work_dir", str(tmp_path),
            "--n_devices", "2", "--batch_size", "16", "--epochs", "1",
            "--e_dim", "32", "--hid_dim_alpha", "2", "--message_steps", "2",
            "--mol_block", "_TripletMessage"]
    assert run.main(argv) is None
    runs = [d for d in (tmp_path / "log_demo").iterdir() if d.is_dir()]
    assert len(runs) == 1 and (runs[0] / "best_save.pt").exists()
    assert len((tmp_path / "log_demo" / "results.jsonl").read_text()
               .splitlines()) == 1
    lines = (runs[0] / "log.txt").read_text().strip().splitlines()
    assert lines[-1].startswith("{'testloss'")
    assert sum(line.startswith("{'testloss'") for line in lines) == 1
    result = json.loads((runs[0] / "result.json").read_text())
    assert len(result["kernel_launches_by_rank"]) == 2
    assert result["config"]["n_devices"] == 2
    # gloo ranks on the CPU replay no graphs, and each says why
    assert [g["step_graphs"] for g in result["step_graphs_by_rank"]] \
        == [False, False]
    assert all("CPU" in g["reason"] for g in result["step_graphs_by_rank"])


def test_cli_ranks_need_a_card_unless_asked_for_the_cpu(tmp_path):
    from glam_tpu_torch import run
    argv = ["--dataset", "demo", "--dataset_root", str(tmp_path),
            "--n_devices", "2"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(argv)
