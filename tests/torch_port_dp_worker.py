"""One rank of the port's data-parallel, halo and node-sharded checks,
started by ``tests/test_torch_port_dp.py``,
``tests/test_torch_port_partition.py``, ``tests/test_torch_port_sharded.py``
and ``tests/test_torch_port_sharded_trainer.py`` (gloo ranks on the CPU),
by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` (gloo ranks
sharing one card) and by ``scripts/sharded_cards.py`` (one card a rank),
with ``GLAM_COORDINATOR``,
``GLAM_NUM_PROCESSES`` and ``GLAM_PROCESS_ID`` set (``spawn_ranks``):

    python tests/torch_port_dp_worker.py <work dir> <cpu|cuda>

It imports no JAX.  ``<work dir>/plan.json`` names the tasks, and may
name the configurations (``configs``: {name: the CLI's args}, default
CONFIGS) and the demo corpus's root (``root``, default: graphs of
SMILES).  A config's initial weights are ``init_<name>.pt`` where the
caller wrote one, else from its seed.  Rank 0 saves what the ranks
computed to ``<work dir>/rank0.pt``:
  step     per config: the merged evaluation (outputs, labels, loss) from
           the initial weights, then the state after one SGD step on the
           first global batch of the training loader, each rank's
           kernel launches in that step, and the collectives (calls of
           ``torch.distributed``) that step and one evaluation step
           make;
  time     on the card, each rank's: the first config's step, eager and
           replayed through the rank's step graphs in turns (median host
           ms of 20 each, and the profiles' busy ms after a barrier, with
           and without the collectives' kernels), the gradient
           all-reduce's buffer (floats, median ms of 20; under nccl also
           through a gloo group of the same ranks) and, with ``halo.pt``
           (cut for the job's ranks), the v1 and v2 halo steps' median
           ms;
  graphs   on the card, per config of ``graphs`` ({name: the CLI's
           args}): 19 steps from one state through the trainer's
           ``RankStepGraphs`` (8 + 8 + 3, the learning rate cut between)
           and the same steps eagerly: rank 0's state, losses,
           launches and graph stats of each run, and every rank's state
           after the captured run;
  ddi      a 1-epoch DDI pair trainer's per-epoch losses;
  dist     process_shard, global_mesh, the rank count and the backend;
  measure  bench_scaling.measure(ranks, graphs_per_device=8, n_iter=2);
  partial  each rank's state after one make_dp_train_step SGD step of
           PARTIAL_LAYERS linear layers, rank k's forward reaching layer
           k alone (so each has a gradient on one rank only); and after
           two Adam steps of PARTIAL_LAYERS + 1 layers, the last reached
           by no rank (``partial_adam``: states, the step's gradient
           set, the untouched layer's gradients and Adam state);
  halo     the v1 and v2 halo message steps on this rank's shard of
           ``halo.pt`` (parameters, the split graph and the v2 plan),
           every rank's output gathered, and each rank's launches;
  sharded  the node-sharded tower (``parallel/sharded_model.py``) on the
           cases of ``sharded.pt`` (:func:`task_sharded`), and on the
           card its step's, halo's and collectives' times
           (``sharded_time``, :func:`task_sharded_time`); both skip the
           cases marked ``captured_only``;
  sharded_graphs  on the card under nccl, the sharded step captured
           whole, its collectives inside (:func:`task_sharded_graphs`),
           and for the cases marked ``overlap_ab`` that step with
           ``GLAM_SHARDED_OVERLAP`` 1 and 0 (:func:`_overlap_ab`);
  sharded_overlap  eagerly on any backend, those cases' forward,
           gradients and step with the overlap on and off in turns
           (:func:`task_sharded_overlap`);
  strainer the sharded DTI trainer (``train/sharded_pair_trainer.py``)
           on the runs of ``strainer.pt`` (:func:`task_strainer`), one
           of them through static slots (``slots``);
  rank_sum the rank-ordered sum (``distributed.all_reduce_sum``) over
           the first n ranks, n = 2 .. all (:func:`task_rank_sum`);
  sharded_autograd  for each case of ``sharded.pt``, a2a and ring: the
           autograd nodes of the sharded forward's loss and the CSR
           sums its forward and backward call (:func:`task_sharded_autograd`);
  sharded_twice  each case of ``sharded.pt``'s loss backward twice from
           its state, eagerly: both runs' outputs and gradients.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import statistics
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from glam_tpu_torch.chem.featurize import smiles_to_arrays  # noqa: E402
from glam_tpu_torch.data.graph import GraphArrays  # noqa: E402
from glam_tpu_torch.nn.model import (Architecture,  # noqa: E402
                                     model_config_from_args)
from glam_tpu_torch.ops.kernels import launch_counts  # noqa: E402
from glam_tpu_torch.parallel import (bench_scaling,  # noqa: E402
                                     data_parallel, distributed)
from glam_tpu_torch.train.trainer import Trainer  # noqa: E402

# tests/conftest.py's SMILES_SET
SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O",
          "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
          "Clc1cc2c(Oc3ccccc3C3CN(CC32)C)cc1", "C"]
# no dropout, no RReLU noise: the steps are deterministic
ARGS = {"dataset": "dp_demo", "epochs": 1, "batch_size": 8, "e_dim": 32,
        "hid_dim_alpha": 2, "message_steps": 2,
        "mol_block": "_TripletMessage", "mol_readout": "GlobalPool5",
        "seed": 3, "loss": "mse", "pre_act": "CELU", "graph_act": "CELU",
        "flat_act": "CELU", "end_act": "CELU", "pre_do": "_None()",
        "graph_do": "_None()", "flat_do": "_None()", "end_do": "_None()",
        "graph_norm": "_PairNorm", "task": "regression", "num_tasks": 1,
        "optim": "SGD", "lr": 0.1}
CONFIGS = {
    "flagship": {},
    "light_set2set_bn": {"mol_block": "_TripletMessageLight",
                         "mol_readout": "Set2Set",
                         "graph_norm": "_BatchNorm",
                         "flat_norm": "_BatchNorm"},
}
N_TRAIN, N_VALID = 6, 40


def graphs(n: int, seed: int = 0):
    """``n`` graphs of SMILES cycled, labels from a seed."""
    ys = np.random.RandomState(seed).randn(n)
    out = []
    for i in range(n):
        x, snd, rcv, e = smiles_to_arrays(SMILES[i % len(SMILES)])
        out.append(GraphArrays(x, e, snd, rcv,
                               np.asarray([ys[i]], np.float32),
                               SMILES[i % len(SMILES)]))
    return out


def config_args(name: str, n_devices: int):
    args = dict(ARGS, **CONFIGS[name], n_devices=n_devices)
    cfg = model_config_from_args(args, mol_in_dim=15, mol_edge_in_dim=4,
                                 out_dim=1, max_nodes=32)
    return args, cfg


def trainer(name: str, n_devices: int, work: Path, device, args=None,
            root=None) -> Trainer:
    """Config ``name``'s trainer (``args``: the CLI's, default ARGS with
    CONFIGS[name]) over ``n_devices`` ranks, from ``init_<name>.pt`` if
    there is one, else from its seed: on the demo corpus at ``root``,
    else on ``N_TRAIN`` training and ``N_VALID`` validation graphs."""
    from glam_tpu_torch.data.batching import max_graph_nodes
    from glam_tpu_torch.data.datasets import MolDataset
    args = dict(args or dict(ARGS, **CONFIGS[name]), n_devices=n_devices)
    if root:
        ds = MolDataset(str(root), "demo")
        train, valid = ds.train, ds.val
        dims = ds.num_node_features, ds.num_edge_features
        max_nodes = max_graph_nodes(ds.graphs)
    else:
        train, valid = graphs(N_TRAIN), graphs(N_VALID, seed=1)
        dims, max_nodes = (15, 4), 32
    cfg = model_config_from_args(args, mol_in_dim=dims[0],
                                 mol_edge_in_dim=dims[1], out_dim=1,
                                 max_nodes=max_nodes)
    model = Architecture(cfg, torch.Generator().manual_seed(args["seed"]))
    init = work / f"init_{name}.pt"
    if init.exists():
        model.load_state_dict(torch.load(init))
    return Trainer(args, model, train, valid, print_log=False,
                   work_dir=str(work / f"{name}_d{n_devices}"), device=device)


COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "all_to_all", "all_to_all_single",
               "batch_isend_irecv", "reduce_scatter_tensor", "barrier",
               "all_gather_object", "broadcast_object_list")


@contextlib.contextmanager
def count_collectives():
    """{"n": the calls of ``torch.distributed``'s collectives} made
    inside the block."""
    counts = {"n": 0}
    saved = {name: getattr(torch.distributed, name) for name in COLLECTIVES}

    def counted(fn):
        def call(*args, **kwargs):
            counts["n"] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(torch.distributed, name, counted(fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(torch.distributed, name, fn)


def step_and_eval(tr: Trainer):
    """The merged evaluation from the current weights, one evaluation
    step on the first validation batch, then one step on the first
    training batch: {out, y, loss, state, launches (of the step),
    collectives (of the training and the evaluation step)}."""
    out, y, loss = tr._gather("valid")
    tr.model.eval()
    vb = tr._to_device(next(iter(tr.valid_loader)))
    with torch.inference_mode(), count_collectives() as evaluation:
        (tr._dp_eval if tr.n_devices > 1 else tr._eval_step)(vb)
    tr.model.train()
    batch = tr._to_device(next(iter(tr.train_loader)))
    before = launch_counts()
    with count_collectives() as training:
        tr.train_step(batch)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    state = {k: v.detach().cpu().clone()
             for k, v in tr.model.state_dict().items()}
    return {"out": out, "y": y, "loss": loss, "state": state,
            "launches": launches,
            "collectives": {"train": training["n"],
                            "eval": evaluation["n"]}}


def _configs(plan):
    return plan.get("configs") or {name: None for name in CONFIGS}


def _by_rank(x):
    """[every rank's ``x``] in rank order."""
    every = [None] * distributed.world()[1]
    torch.distributed.all_gather_object(every, x)
    return every


def task_step(work, plan, dev):
    ranks = distributed.world()[1]
    out = {}
    for name, args in _configs(plan).items():
        got = step_and_eval(trainer(name, ranks, work, dev, args,
                                    plan.get("root")))
        got["launches"] = _by_rank(got["launches"])
        out[f"step_{name}"] = got
    return out


def _median_ms(fn, reps=20):
    """Median host ms of ``fn()``, each call between two synchronizes
    with the card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(label, fn):
    """``chip_smoke.print_profile`` of ``fn`` once every rank has reached
    it (a barrier, then a synchronisation), so that the profile holds no
    wait for a late peer."""
    from chip_smoke import print_profile
    torch.distributed.barrier()
    torch.cuda.synchronize()
    return print_profile(label, fn)


def task_time(work, plan, dev):
    if dev.type != "cuda":
        raise ValueError("the time task measures on the card")
    rank, ranks = distributed.world()
    name, args = next(iter(_configs(plan).items()))
    tr = trainer(name, ranks, work, dev, args, plan.get("root"))
    tr.model.train()
    batch = tr._to_device(next(iter(tr.train_loader)))
    step = lambda: tr.train_step(batch)  # noqa: E731
    for _ in range(3):
        step()
    # the same step replayed through the rank's step graphs, timed in
    # turns with the eager one (eager, replayed, eager, replayed)
    graphs = tr.step_graphs
    host = tuple(p.to("cpu") for p in batch)
    seeds = iter(range(1 << 30))
    replay = lambda: graphs.train([host], False, [next(seeds)])  # noqa
    replay()                  # the warm-up, eager; then the captures
    replay()
    turns = {"eager": [], "replayed": []}
    for _ in range(2):
        turns["eager"].append(_median_ms(step))
        turns["replayed"].append(_median_ms(replay))
    got = {"host_ms": statistics.median(turns["eager"]),
           "turns": turns, "design": graphs.design,
           "graph_stats": dict(graphs.stats),
           "busy": _profile(f"rank {rank} data-parallel step", step),
           "busy_replayed": _profile(f"rank {rank} data-parallel step "
                                     f"replayed ({graphs.design})", replay)}
    params = [p for p in tr.model.parameters() if p.requires_grad]
    stats = data_parallel.running_stats(tr.model)
    # make_dp_train_step's buffer: the gradients, the running statistics,
    # the weight, the weighted loss and a flag a parameter
    n = sum(p.numel() for p in params) + sum(b.numel() for b in stats) \
        + 2 + len(params)
    flat = torch.zeros(n, device=dev)
    got["all_reduce_floats"] = n
    got["all_reduce_ms"] = _median_ms(
        lambda: distributed.all_reduce_sum(flat))
    if torch.distributed.get_backend() != "gloo":
        # the same buffer through gloo on the same ranks (staged through
        # the host), for the backends to be read against each other
        gloo = torch.distributed.new_group(backend="gloo")
        got["all_reduce_gloo_ms"] = _median_ms(
            lambda: distributed.all_reduce_sum(flat, gloo))
    if (work / "halo.pt").exists():
        v1, v2 = _halo_steps(work, dev)
        got["halo_ms"] = [_median_ms(v1), _median_ms(v2)]
    gloo = got.get("all_reduce_gloo_ms")
    print(f"rank {rank}: {torch.distributed.get_backend()} on {dev}: one "
          f"data-parallel step host_ms={got['host_ms']:.4f} busy_ms="
          f"{got['busy']['busy_ms']:.4f}; all_reduce of {n} floats "
          f"all_reduce_ms={got['all_reduce_ms']:.4f}"
          + ("" if gloo is None else f" (through gloo {gloo:.4f})")
          + f"; host ms in turns eager {turns['eager']}, replayed "
          f"{turns['replayed']}", flush=True)
    return {"time": _by_rank(got)}


GRAPH_PLAN = [(0, 8), (8, 16), "lr", (16, 19)]


def _graph_run(name, args, work, dev, plan, captured):
    """A fresh trainer's steps of GRAPH_PLAN over its first training
    items (the learning rate cut by 0.7 at "lr"), through its step graphs
    if ``captured``, else eagerly: (state with the optimizer's, losses,
    launches, graph stats, learning rate)."""
    import gc
    import itertools
    from glam_tpu_torch.train.optim import (get_learning_rate,
                                            set_learning_rate)
    tr = trainer(name, distributed.world()[1], work, dev, args,
                 plan.get("root"))
    if not captured:
        tr.step_graphs = None
    tr.model.train()
    n = max(p[1] for p in GRAPH_PLAN if p != "lr")
    host = [tr._as_parts(h) for h in itertools.islice(
        itertools.cycle(tr.train_loader), n)]
    before = launch_counts()
    losses = []
    for part in GRAPH_PLAN:
        if part == "lr":
            set_learning_rate(tr.optimizer,
                              0.7 * get_learning_rate(tr.optimizer))
            continue
        losses.append(tr._train_group(host[part[0]:part[1]]))
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    state = {k: v.detach().cpu().clone()
             for k, v in tr.model.state_dict().items()}
    state.update({f"{i}.{k}": v.detach().cpu().clone()
                  for i, st in enumerate(tr.optimizer.state.values())
                  for k, v in st.items() if torch.is_tensor(v)})
    out = (state, torch.cat(losses).cpu(), launches,
           dict(tr.step_graphs.stats) if captured else None,
           get_learning_rate(tr.optimizer))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def task_graphs(work, plan, dev):
    if dev.type != "cuda":
        raise ValueError("the graphs task runs on the card")
    out = {}
    for name, args in plan["graphs"].items():
        runs = {run: _graph_run(name, args, work, dev, plan,
                                run == "captured")
                for run in ("eager", "captured")}
        out[name] = {"runs": runs,
                     "captured_by_rank": _by_rank(runs["captured"][0])}
    return {"graphs": out}


def task_ddi(work, plan, dev):
    from glam_tpu_torch.data.pair_datasets import DDIDataset
    from glam_tpu_torch.train.pair_trainer import make_ddi_trainer
    args = dict(plan["ddi_args"], n_devices=distributed.world()[1])
    tr = make_ddi_trainer(args, DDIDataset(plan["ddi_root"]),
                          work_dir=str(work / "ddi"), device=dev)
    tr.model.load_state_dict(torch.load(work / "init_ddi.pt"))
    rec = {"trn": [], "val": []}
    train, valid = tr.train_iterations, tr.valid_iterations

    def train_it():
        rec["trn"].append(train())
        return rec["trn"][-1]

    def valid_it(mode="valid"):
        out = valid(mode)
        rec["val"].append(out[0])
        return out

    tr.train_iterations, tr.valid_iterations = train_it, valid_it
    tr.train()
    return {"ddi": rec}


def task_dist(work, plan, dev):
    rank, ranks = distributed.world()
    shard = [None] * ranks
    torch.distributed.all_gather_object(
        shard, distributed.process_shard(list(range(10))))
    return {"dist": {"ranks": ranks, "shards": shard,
                     "backend": torch.distributed.get_backend(),
                     "mesh": [str(d) for d in distributed.global_mesh(
                         platform=plan["platform"])]}}


def task_measure(work, plan, dev):
    return {"measure": bench_scaling.measure(
        distributed.world()[1], graphs_per_device=8, n_iter=2,
        platform=plan["platform"])}


PARTIAL_LAYERS = 2


def partial_model(seed=0):
    """``PARTIAL_LAYERS`` Linear(3, 1) layers from ``seed``."""
    torch.manual_seed(seed)
    return torch.nn.ModuleList(torch.nn.Linear(3, 1)
                               for _ in range(PARTIAL_LAYERS))


def task_partial(work, plan, dev):
    rank = distributed.world()[0]
    model = partial_model().to(dev)
    x = torch.ones(4, 3, device=dev)
    part = types.SimpleNamespace(y=torch.zeros(4, 1, device=dev),
                                 graph_mask=torch.ones(4, 1, device=dev))
    step = data_parallel.make_dp_train_step(
        model, lambda out, y, m: ((out - y) ** 2).mean(),
        torch.optim.SGD(model.parameters(), lr=0.1),
        forward=lambda parts, generator: model[rank](x))
    step((part,))
    # PARTIAL_LAYERS + 1 layers under Adam: the last reached by no rank
    torch.manual_seed(1)
    wide = torch.nn.ModuleList(torch.nn.Linear(3, 1)
                               for _ in range(PARTIAL_LAYERS + 1)).to(dev)
    opt = torch.optim.Adam(wide.parameters(), lr=0.1)
    adam = data_parallel.make_dp_train_step(
        wide, lambda out, y, m: ((out - y) ** 2).mean(), opt,
        forward=lambda parts, generator: wide[rank](x))
    for _ in range(2):
        adam((part,))
    last = wide[PARTIAL_LAYERS]
    return {"partial": _by_rank({k: v.cpu()
                                 for k, v in model.state_dict().items()}),
            "partial_adam": _by_rank({
                "state": {k: v.cpu() for k, v in wide.state_dict().items()},
                "had": adam.had,
                "untouched_grads": [p.grad is None
                                    for p in last.parameters()],
                "untouched_adam_state": [len(opt.state[p])
                                         for p in last.parameters()]})}


def _halo_steps(work, dev):
    """This rank's v1 and v2 halo steps on its shard of ``halo.pt``, as
    calls of no arguments."""
    from glam_tpu_torch.parallel import graph_partition as gp
    rank, ranks = distributed.world()
    h = torch.load(work / "halo.pt")
    if h["nodes"].shape[0] != ranks:       # on every rank alike
        raise ValueError(f"halo.pt holds {h['nodes'].shape[0]} shards for "
                         f"{ranks} ranks")
    p = {k: v.to(dev) for k, v in h["params"].items()}
    s = {k: v[rank].to(dev) for k, v in h.items() if k != "params"}
    v1, v2 = gp.make_halo_message_step(), gp.make_halo_message_step_v2()
    return (lambda: v1(p, s["nodes"], s["edges"], s["senders_global"],
                       s["receivers"], s["edge_mask"]),
            lambda: v2(p, s["nodes"], s["edges"], s["senders_local"],
                       s["receivers"], s["edge_mask"], s["send_idx"]))


def _halo_grads(work, dev):
    """Each halo step's gradient of sum(out * w) over every shard (w
    [ranks * Nl, C] from seed 3): the parameters' on this rank, every
    rank's node rows' gathered."""
    from glam_tpu_torch.parallel import graph_partition as gp
    rank, ranks = distributed.world()
    h = torch.load(work / "halo.pt")
    s = {k: v[rank].to(dev) for k, v in h.items() if k != "params"}
    Nl, C = s["nodes"].shape[0], h["params"]["weight_node"].shape[1]
    w = torch.randn(ranks * Nl, C, generator=torch.Generator().manual_seed(
        3))[rank * Nl:(rank + 1) * Nl].to(dev)
    out = {}
    for name, step, snd, extra in (
            ("v1", gp.make_halo_message_step(), "senders_global", ()),
            ("v2", gp.make_halo_message_step_v2(), "senders_local",
             (s["send_idx"],))):
        p = {k: v.to(dev).clone().requires_grad_()
             for k, v in h["params"].items()}
        x = s["nodes"].clone().requires_grad_()
        y = step(p, x, s["edges"], s[snd], s["receivers"], s["edge_mask"],
                 *extra)
        distributed.reduce_to_replicated((y * w).sum()).backward()
        out[name] = {"params": {k: v.grad.cpu() for k, v in p.items()},
                     "nodes": distributed.all_gather(x.grad).cpu()}
    return out


def task_halo(work, plan, dev):
    before = launch_counts()
    v1, v2 = (step() for step in _halo_steps(work, dev))
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return {"halo": {"v1": distributed.all_gather(v1).cpu(),
                     "v2": distributed.all_gather(v2).cpu(),
                     "launches": _by_rank(launches),
                     "grads": _halo_grads(work, dev)}}


# ------------------------------------------------- the node-sharded tower
def _grads(model):
    return {k: (p.grad.detach().cpu().clone() if p.grad is not None
                else torch.zeros_like(p).cpu())
            for k, p in model.named_parameters()}


def _sharded_model(case, dev):
    from glam_tpu_torch.nn.model import (Architecture, ModelConfig,
                                         PairArchitecture)
    cfg = ModelConfig(**case["cfg"])
    model = (PairArchitecture(cfg, hetero=True) if case["kind"] == "pair"
             else Architecture(cfg))
    model.load_state_dict(case["state"])
    return model.to(dev).train(case.get("train", False))


def sharded_case(case, dev, group=None, halo=None, pairs=None, noise=None,
                 generator_seed=None):
    """One case's sharded forward on this rank (over ``group``, default
    every rank), its loss (mean squared error to 0.3) backward: {out,
    grads, buffers}.  ``pairs``: indices into the case's proteins packed
    as one step (default [0])."""
    from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
    from glam_tpu_torch.parallel import sharded_model as sm
    rank, D = (torch.distributed.get_rank(group),
               torch.distributed.get_world_size(group))
    model = _sharded_model(case, dev)
    before = launch_counts()
    halo = halo or case.get("halo", "a2a")
    pairs = pairs if pairs is not None else [0]
    graphs = [GraphArrays(*case["graphs"][i], y=np.zeros(1, np.float32))
              for i in pairs]
    budgets = sm.corpus_budgets(graphs, D, halo)
    shard = sm.pack_shards([sm.shard_at(g, D, rank, budgets)
                            for g in graphs], D).to(dev)
    if noise is not None:                 # (seed, rate)
        gen = torch.Generator().manual_seed(noise[0])
        cfg = model.cfg
        draws = [sm.make_stochastic_inputs(
            gen, g.nodes.shape[0], cfg.hid_dim, cfg.message_steps, D,
            rate=noise[1]) for g in graphs]
        noise = tuple(t.to(dev) for t in sm.local_noise(draws, rank))
    if case["kind"] == "pair":
        mols = [GraphArrays(*case["mols"][i]) for i in pairs]
        mol_b = pad_graphs(mols, len(mols), 64 * len(mols),
                           128 * len(mols), num_tasks=1).to(dev)
        out = sm.make_sharded_pair_forward(model, group)(
            mol_b, shard, noise=noise)
    else:
        out = sm.make_sharded_forward(model, group)(shard, noise=noise)
    ((out - 0.3) ** 2).mean().backward()
    return {"out": out.detach().cpu(), "grads": _grads(model),
            "launches": {k: v - before[k]
                         for k, v in launch_counts().items()},
            "buffers": {k: v.cpu().clone() for k, v in model.named_buffers()
                        if k.endswith((".mean", ".var"))}}


def _first_pair(case, dev, halo="a2a"):
    """(model, molecule batch or None, this rank's shard) of a case's
    first graph, over every rank."""
    from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
    from glam_tpu_torch.parallel import sharded_model as sm
    rank, D = distributed.world()
    g = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    shard = sm.pack_shards([sm.shard_at(
        g, D, rank, sm.corpus_budgets([g], D, halo))], D).to(dev)
    mol_b = (pad_graphs([GraphArrays(*case["mols"][0])], 1, 64, 128,
                        num_tasks=1).to(dev) if case["kind"] == "pair"
             else None)
    return _sharded_model(case, dev), mol_b, shard


def with_overlap(flag: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``GLAM_SHARDED_OVERLAP`` set to
    ``flag`` while the sharded towers it builds read it."""
    saved = os.environ.get("GLAM_SHARDED_OVERLAP")
    os.environ["GLAM_SHARDED_OVERLAP"] = flag
    try:
        return fn(*args, **kwargs)
    finally:
        if saved is None:
            del os.environ["GLAM_SHARDED_OVERLAP"]
        else:
            os.environ["GLAM_SHARDED_OVERLAP"] = saved


def task_sharded(work, plan, dev):
    """Every case of ``sharded.pt`` ({name: {kind, cfg, state, graphs
    (nodes, edges, senders, receivers) a protein, mols, train, halo}}):
    the forward and gradients at a2a (and ring where the case asks),
    two pairs packed in one step against each alone, the noise at 2
    shards against 1 (rank 0 alone) and at rate 0, a2a and ring with
    ``GLAM_SHARDED_OVERLAP`` 1 and 0 (``overlap``), and one Adam step's
    parameters on each rank."""
    from glam_tpu_torch.parallel import sharded_model as sm
    rank = distributed.world()[0]
    cases = torch.load(work / "sharded.pt", weights_only=False)
    solo = torch.distributed.new_group([0])
    out = {}
    for name, case in cases.items():
        if case.get("captured_only"):
            continue
        got = {"a2a": sharded_case(case, dev)}
        got["launches"] = _by_rank(got["a2a"]["launches"])
        if case.get("ring"):
            got["ring"] = sharded_case(case, dev, halo="ring")
        if case.get("batched"):
            got["both"] = sharded_case(case, dev, pairs=[0, 1])
            got["alone"] = [sharded_case(case, dev, pairs=[i])
                            for i in (0, 1)]
        if case.get("noise"):
            got["noise_d2"] = sharded_case(case, dev, noise=(5, 0.2))
            got["rate0"] = sharded_case(case, dev, noise=(5, 0.0))
            if rank == 0:
                got["noise_d1"] = sharded_case(case, dev, group=solo,
                                               noise=(5, 0.2))
        if case.get("overlap"):      # GLAM_SHARDED_OVERLAP on and off
            got["overlap"] = {halo: {flag: with_overlap(
                flag, sharded_case, case, dev, halo=halo)
                for flag in ("1", "0")} for halo in ("a2a", "ring")}
        if case.get("sgd"):          # one make_sharded_*_train_step
            model, mol_b, shard = _first_pair(case, dev)
            y = torch.full((1, model.cfg.out_dim), 0.3, device=dev)
            if case["kind"] == "pair":
                sm.make_sharded_pair_train_step(model, lr=0.1)(mol_b, shard,
                                                               y)
            else:
                sm.make_sharded_train_step(model, lr=0.1)(shard, y)
            got["sgd"] = {k: v.detach().cpu().clone()
                          for k, v in model.state_dict().items()}
        if case.get("adam"):
            model, mol_b, shard = _first_pair(case, dev)
            fwd = sm.make_sharded_pair_forward(model)
            opt = torch.optim.Adam(model.parameters(), lr=1e-2)
            ((fwd(mol_b, shard) - 0.3) ** 2).mean().backward()
            sm.sync_grads(model)
            opt.step()
            got["adam"] = _by_rank({k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()})
        out[name] = got
    return {"sharded": out}


def task_sharded_time(work, plan, dev):
    """On the card, for each case of ``sharded.pt`` marked ``time`` and
    each plan (a2a, ring): one Adam step's host ms (median of 10) and the
    profile's busy ms; one message step's halo exchange (ms, median of
    20, and the bytes this rank receives); the gradient's extra
    collectives: the all-reduce of the protein tower's shard-local
    parameter and molecule-state gradients (``enter_local``) and the
    broadcast of every gradient (``sync_grads``), ms and floats."""
    from glam_tpu_torch.parallel import sharded_model as sm
    if dev.type != "cuda":
        raise ValueError("the sharded_time task measures on the card")
    rank = distributed.world()[0]
    cases = torch.load(work / "sharded.pt", weights_only=False)
    out = {}
    for name, case in cases.items():
        if not case.get("time") or case.get("captured_only"):
            continue
        for halo in ("a2a", "ring"):
            model, mol_b, shard = _first_pair(case, dev, halo)
            fwd = sm.make_sharded_pair_forward(model)
            opt = torch.optim.Adam(model.parameters(), lr=1e-4)

            def step():
                loss = ((fwd(mol_b, shard) - 0.3) ** 2).mean()
                opt.zero_grad(set_to_none=True)
                loss.backward()
                sm.sync_grads(model)
                opt.step()

            for _ in range(3):
                step()
            got = {"host_ms": _median_ms(step, reps=10),
                   "busy": _profile(f"rank {rank} sharded step "
                                    f"[{name} {halo}]", step)}
            tower = sm.ShardedTower(model.mol2, model.cfg,
                                    model.cfg.pro_block,
                                    model.cfg.pro_readout)
            conv = tower.conv
            width = (conv.heads * conv.channels
                     if model.cfg.pro_block.strip() == "_TripletMessage"
                     else model.cfg.hid_dim)
            z = torch.randn(shard.n_pairs * shard.n_local, width,
                            device=dev)
            got["halo_ms"] = _median_ms(lambda: tower.halo(z, shard))
            got["halo_rows"] = shard.halo_rows
            got["halo_bytes"] = shard.halo_rows * width * 4
            n_local = sum(tower.params[k].numel()
                          for k in tower.local_names)
            n_mol = model.cfg.message_steps * model.cfg.max_nodes \
                * model.cfg.hid_dim
            n_all = sum(p.numel() for p in model.parameters())
            flat = torch.zeros(n_local + n_mol, device=dev)
            every = torch.zeros(n_all, device=dev)
            got["grad_all_reduce_floats"] = n_local + n_mol
            got["grad_all_reduce_ms"] = _median_ms(
                lambda: distributed.all_reduce_sum(flat))
            got["grad_broadcast_floats"] = n_all
            got["grad_broadcast_ms"] = _median_ms(
                lambda: distributed.broadcast_(every))
            out[f"{name}_{halo}"] = got
    return {"sharded_time": _by_rank(out)}


def task_sharded_graphs(work, plan, dev):
    """On the card under nccl, for each case of ``sharded.pt`` marked
    ``time`` and each plan (a2a, ring): the sharded pair step captured
    whole, its collectives inside.  First a graph of the forward, the
    loss's backward and the gradients' broadcast: one replay's output,
    gradients and launches (rank 0's against the dense model by the
    caller), and its eager warm-up's output and gradients, which the
    replay's must equal bitwise.  Then a graph of the whole Adam step:
    its host ms replayed and eager in turns (medians of 10), the
    profiles' busy ms after a barrier (with and without the collectives'
    kernels), and every rank's parameters after the replays."""
    from glam_tpu_torch.cuda_graphs import CapturedCalls
    from glam_tpu_torch.parallel import sharded_model as sm
    from glam_tpu_torch.train.optim import make_optimizer
    if dev.type != "cuda":
        raise ValueError("the sharded_graphs task runs on the card")
    rank = distributed.world()[0]
    backend = torch.distributed.get_backend()
    if distributed.sharded_step_graphs_for(backend)[0] is None:
        raise ValueError(f"no sharded step graphs under {backend}")
    cases = torch.load(work / "sharded.pt", weights_only=False)
    out = {}
    for name, case in cases.items():
        if not case.get("time"):
            continue
        for halo in ("a2a", "ring"):
            model, mol_b, shard = _first_pair(case, dev, halo)
            fwd = sm.make_sharded_pair_forward(model)
            opt = make_optimizer("Adam", model.named_parameters(), 1e-4)
            calls = CapturedCalls(dev)
            calls.capture_error_mode = \
                distributed.CAPTURE_ERROR_MODE[backend]
            names = [n for n, _ in model.named_parameters()]

            def grads():
                model.zero_grad(set_to_none=True)
                y = fwd(mol_b, shard)
                ((y - 0.3) ** 2).mean().backward()
                sm.sync_grads(model)
                return (y.detach(),) + tuple(
                    p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in model.parameters())

            def step():
                grads()
                opt.step()

            # NCCL's communicators, eagerly: the eager step's result
            eager = [t.cpu().clone() for t in calls.warm_up(grads)]
            graph = calls.capture(grads)
            before = launch_counts()
            res = calls.replay(graph)
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            got = {"out": res[0].cpu().clone(),
                   "grads": {n: g.cpu().clone()
                             for n, g in zip(names, res[1:])},
                   "eager_out": eager[0],
                   "eager_grads": dict(zip(names, eager[1:])),
                   "launches": launches, "sends": shard.halo_sends}
            calls.warm_up(step)           # Adam's state, eagerly
            whole = calls.capture(step)
            replay = lambda: calls.replay(whole)  # noqa: E731
            turns = {"eager": [], "replayed": []}
            for _ in range(2):
                turns["eager"].append(_median_ms(step, reps=10))
                turns["replayed"].append(_median_ms(replay, reps=10))
            got.update(turns=turns, busy=_profile(
                f"rank {rank} sharded step [{name} {halo}] eager", step),
                busy_replayed=_profile(
                    f"rank {rank} sharded step [{name} {halo}] replayed",
                    replay), graph_stats=dict(calls.stats))
            params = _by_rank({k: v.detach().cpu().clone()
                               for k, v in model.state_dict().items()})
            if rank == 0:
                got["params"] = params
            else:
                for k in ("out", "grads", "eager_out", "eager_grads"):
                    got.pop(k)
            if case.get("overlap_ab"):
                got["ab"] = _overlap_ab(case, dev, halo, backend,
                                        f"{name} {halo}")
            out[f"{name}_{halo}"] = got
    return {"sharded_graphs": _by_rank(out)}


def task_sharded_overlap(work, plan, dev):
    """Eagerly (any backend), for each case of ``sharded.pt`` marked
    ``overlap_ab`` and each plan (a2a, ring), four runs in turns with
    ``GLAM_SHARDED_OVERLAP`` 1, 0, 0, 1, each from the case's state: the
    no-grad forward's output, the gradients of the worker's loss (synced
    as a step takes them), the launches of that forward and backward, and
    one Adam step's host ms (median of 5 after 2)."""
    from glam_tpu_torch.parallel import sharded_model as sm
    cases = torch.load(work / "sharded.pt", weights_only=False)
    out = {}
    for name, case in cases.items():
        if not case.get("overlap_ab"):
            continue
        for halo in ("a2a", "ring"):
            runs = []
            for flag in ("1", "0", "0", "1"):
                model, mol_b, shard = _first_pair(case, dev, halo)
                fwd = with_overlap(flag, sm.make_sharded_pair_forward, model)
                with torch.no_grad():
                    y = fwd(mol_b, shard).cpu()
                before = launch_counts()
                ((fwd(mol_b, shard) - 0.3) ** 2).mean().backward()
                sm.sync_grads(model)
                launches = {k: v - before[k]
                            for k, v in launch_counts().items()}
                grads = _grads(model)
                opt = torch.optim.Adam(model.parameters(), lr=1e-4)

                def step(fwd=fwd, mol_b=mol_b, shard=shard, model=model,
                         opt=opt):
                    loss = ((fwd(mol_b, shard) - 0.3) ** 2).mean()
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    sm.sync_grads(model)
                    opt.step()

                for _ in range(2):
                    step()
                ms = _median_ms(step, reps=5) if dev.type == "cuda" \
                    else None
                runs.append({"flag": flag, "out": y, "grads": grads,
                             "launches": launches, "step_ms": ms})
            out[f"{name}_{halo}"] = runs
    return {"sharded_overlap": out}


def overlap_schedule(fn):
    """From a profiler trace of one call of ``fn``: the device kernels,
    the NCCL ones among them (their count and summed duration, the
    halo's ``AllToAll``/``SendRecv`` ones apart), the busy ms without
    them, and the other kernels that start inside an NCCL kernel's span
    (their count and summed ms: the tower's work beside the exchange)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    own = [e for e in kernels if "nccl" not in e.name.lower()]
    halo = [e for e in nccl if any(k in e.name.lower() for k in
                                   ("alltoall", "sendrecv", "send", "recv"))]
    spans = [(e.time_range.start, e.time_range.end) for e in nccl]
    inside = [e for e in own
              if any(a <= e.time_range.start < b for a, b in spans)]
    in_halo = [e for e in own if any(
        a <= e.time_range.start < b for a, b in
        ((h.time_range.start, h.time_range.end) for h in halo))]
    ms = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3  # noqa
    names = {}
    for e in in_halo:
        names[e.name[:48]] = names.get(e.name[:48], 0) + 1
    return {"kernels": len(kernels), "busy_ms": ms(kernels),
            "busy_own_ms": ms(own), "nccl_kernels": len(nccl),
            "nccl_ms": ms(nccl), "halo_kernels": len(halo),
            "halo_ms": ms(halo), "inside_nccl": len(inside),
            "inside_nccl_ms": ms(inside), "inside_halo": len(in_halo),
            "inside_halo_ms": ms(in_halo),
            "inside_halo_names": sorted(names.items(),
                                        key=lambda kv: -kv[1])[:8]}


def _overlap_ab(case, dev, halo, backend, label):
    """The case's sharded Adam step with ``GLAM_SHARDED_OVERLAP`` 1 and 0,
    each captured whole from the case's state: the no-grad forward's
    output eagerly and replayed (bitwise equal across the two), the
    launches of a replay of the step, its host ms replayed and eager in
    turns (1, 0, 0, 1; medians of 10), and each replay's
    :func:`overlap_schedule` after a barrier."""
    from glam_tpu_torch.cuda_graphs import CapturedCalls
    from glam_tpu_torch.parallel import sharded_model as sm
    from glam_tpu_torch.train.optim import make_optimizer
    runs = {}
    for flag in ("1", "0"):
        model, mol_b, shard = _first_pair(case, dev, halo)
        fwd = with_overlap(flag, sm.make_sharded_pair_forward, model)
        opt = make_optimizer("Adam", model.named_parameters(), 1e-4)
        calls = CapturedCalls(dev)
        calls.capture_error_mode = distributed.CAPTURE_ERROR_MODE[backend]

        def infer(fwd=fwd, mol_b=mol_b, shard=shard):
            with torch.no_grad():
                return (fwd(mol_b, shard),)

        def step(fwd=fwd, mol_b=mol_b, shard=shard, model=model, opt=opt):
            loss = ((fwd(mol_b, shard) - 0.3) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            sm.sync_grads(model)
            opt.step()
            return (loss.detach(),)

        eager_out = infer()[0].cpu()
        calls.warm_up(infer)
        forward = calls.capture(infer)
        replayed_out = calls.replay(forward)[0].cpu().clone()
        calls.warm_up(step)
        whole = calls.capture(step)
        before = launch_counts()
        calls.replay(whole)
        torch.cuda.synchronize()
        runs[flag] = {
            "out": eager_out, "out_replayed": replayed_out,
            "launches": {k: v - before[k]
                         for k, v in launch_counts().items()},
            "replayed": lambda calls=calls, whole=whole: calls.replay(whole),
            "eager": step}
    turns = {f"{kind} {flag}": [] for kind in ("replayed", "eager")
             for flag in ("1", "0")}
    for kind in ("replayed", "eager"):
        for flag in ("1", "0", "0", "1"):
            turns[f"{kind} {flag}"].append(_median_ms(runs[flag][kind],
                                                      reps=10))
    schedule = {}
    for flag in ("1", "0"):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        schedule[flag] = overlap_schedule(runs[flag]["replayed"])
        print(f"overlap {label} GLAM_SHARDED_OVERLAP={flag} replayed: "
              f"{json.dumps(schedule[flag])}", flush=True)
    out = {"turns": turns, "schedule": schedule,
           **{f"{k} {flag}": runs[flag][k] for flag in ("1", "0")
              for k in ("out", "out_replayed", "launches")}}
    del runs
    torch.cuda.empty_cache()
    return out


def dense_float64_grads(tr):
    """The dense pair model's gradients, in float64, at the sharded
    trainer ``tr``'s weights on its first training pair (the first of
    epoch 1's order), of the loss its first step takes.  The convs cast
    their kernels' inputs to float32 (``nn/convs.py``); here ``.float()``
    leaves a float64 tensor float64, so that the plain kernels run in
    float64 as well."""
    from glam_tpu_torch.data.graph import pad_graphs
    from glam_tpu_torch.nn.model import PairArchitecture
    train = tr.splits["train"]
    first = np.random.RandomState(int(tr.args.get("seed", 1234))
                                  + tr._start_epoch).permutation(len(train))
    mol, pro = train[first[0]]
    model = PairArchitecture(tr.model.cfg, hetero=True)
    model.load_state_dict(tr.model.state_dict())
    model = model.double().train()
    g1, g2 = (pad_graphs([g], 1, g.nodes.shape[0] + 1,
                         max(g.senders.shape[0], 1), num_tasks=1).cast(
                             torch.float64) for g in (mol, pro))
    y = torch.tensor([float(mol.y.reshape(-1)[0])], dtype=torch.float64)
    to_float = torch.Tensor.float
    torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
        else to_float(t)
    try:
        tr.loss(model(g1, g2)[:1], y).sum().backward()
    finally:
        torch.Tensor.float = to_float
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def task_strainer(work, plan, dev):
    """The sharded DTI trainer on each run of ``strainer.pt`` ({name:
    {args, root, init (state_dict or None), epochs, resume_from (a run
    name)}}), in order: records, final line, and the best checkpoint's
    run dir; with ``logits``, the test split's logits in evaluation mode
    after training; with ``first_grads``, the first optimizer step's
    gradients; and every run's final state."""
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.train.sharded_pair_trainer import ShardedPairTrainer
    runs = torch.load(work / "strainer.pt", weights_only=False)
    out, dirs = {}, {}
    for name, run in runs.items():
        args, ds, kind = auto_dataset(dict(run["args"],
                                           dataset_root=run["root"]))
        tr = ShardedPairTrainer(args, ds, task=kind,
                                work_dir=str(work / "strainer" / name),
                                device=dev)
        if run.get("init") is not None:
            tr.model.load_state_dict(run["init"])
            tr._best_state = tr._state_copy()
        if run.get("resume_from"):
            tr.resume(dirs[run["resume_from"]])
        if run.get("slots"):
            # the graph-ready form: every input of a step and of an
            # evaluation enters through a static slot (as a captured
            # step's do), run eagerly
            from glam_tpu_torch.cuda_graphs import Slots, signature
            slots = {}

            def through_slots(item, _slots=slots, _tr=tr):
                sig = signature(item)
                if sig not in _slots:
                    _slots[sig] = Slots(item, _tr.device)
                _slots[sig].load(item)
                return _slots[sig].parts
            tr._on_device = through_slots
        got = {}
        if run.get("first_grads"):
            got["float64_grads"] = dense_float64_grads(tr)
            # the first step's gradients, synced, as the optimizer takes
            # them
            step = tr.optimizer.step

            def first_step(*a, _step=step, _got=got, _tr=tr, **k):
                if "first_grads" not in _got:
                    _got["first_grads"] = {
                        n: p.grad.detach().cpu().clone()
                        for n, p in _tr.model.named_parameters()
                        if p.grad is not None}
                return _step(*a, **k)
            tr.optimizer.step = first_step
        if run.get("train_only"):
            tr.train()
        else:
            got["final"] = tr.train_and_test()
        got.update(records=tr.records, run_dir=str(tr.log_save_dir))
        dirs[name] = tr.log_save_dir
        if run.get("logits"):
            logits = []
            for pair in tr.splits["test"]:
                logits.append(tr.evaluate(tr._item([pair]))[0].cpu())
            got["logits"] = torch.cat(logits)
            got["test_pairs"] = [(m.smi, p.smi) for m, p in
                                 tr.splits["test"]]
        got["params"] = _by_rank({k: v.detach().cpu().clone()
                                  for k, v in tr.model.state_dict().items()})
        out[name] = got
    return {"strainer": out}


def rank_terms(rank: int) -> torch.Tensor:
    """Rank ``rank``'s term of the rank-ordered sum's check: [64, 64]
    float32 of magnitudes 1e-4 to 1e4, so that the order of the adds
    shows in the bits."""
    rng = np.random.RandomState(100 + rank)
    return torch.from_numpy((rng.randn(64, 64) * 10.0 ** rng.uniform(
        -4, 4, (64, 64))).astype(np.float32))


def task_rank_sum(work, plan, dev):
    """For n = 2 .. the rank count, over a group of the first n ranks:
    each member's :func:`rank_terms` summed by ``all_reduce_sum``, and at
    n = 2 by ``torch.distributed.all_reduce`` too; every rank's result."""
    rank, ranks = distributed.world()
    out = {}
    for n in range(2, ranks + 1):
        group = torch.distributed.new_group(list(range(n)))
        mine = None
        if rank < n:
            t = rank_terms(rank).to(dev)
            mine = {"sum": distributed.all_reduce_sum(t.clone(),
                                                      group).cpu()}
            if n == 2:
                ref = t.clone()
                torch.distributed.all_reduce(ref, group=group)
                mine["all_reduce"] = ref.cpu()
        out[n] = _by_rank(mine)
    return {"rank_sum": out}


def _autograd_nodes(root):
    """The names of every node of the autograd graph under ``root``."""
    seen, todo, names = set(), [root], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def task_sharded_autograd(work, plan, dev):
    """Each case of ``sharded.pt``, a2a and ring, on this rank's shard:
    the names of the autograd nodes under the loss of the sharded
    forward, and the CSR sums (calls of the plain version, a kernel
    launch each on the card) of its forward and of its backward."""
    from glam_tpu_torch.ops.kernels import segment_sum_csr as csr_mod
    from glam_tpu_torch.ops.kernels import triplet_fused
    calls = [0]
    plain = csr_mod.segment_sum_csr_plain

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    csr_mod.segment_sum_csr_plain = counted
    triplet_fused.segment_sum_csr_plain = counted
    cases = torch.load(work / "sharded.pt", weights_only=False)
    out = {}
    try:
        for name, case in cases.items():
            for halo in ("a2a", "ring"):
                calls[0] = 0
                loss, shard = _sharded_loss(case, dev, halo)
                fwd = calls[0]
                names = _autograd_nodes(loss.grad_fn)
                loss.backward()
                out[f"{name}_{halo}"] = {
                    "nodes": sorted(names), "csr": (fwd, calls[0] - fwd),
                    "sends": shard.halo_sends}
    finally:
        csr_mod.segment_sum_csr_plain = plain
        triplet_fused.segment_sum_csr_plain = plain
    return {"sharded_autograd": out}


def _sharded_loss(case, dev, halo):
    """(the worker's loss of a single-graph case's sharded forward on its
    first graph, this rank's shard), the backward not taken."""
    from glam_tpu_torch.parallel import sharded_model as sm
    rank, D = distributed.world()
    g = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    shard = sm.pack_shards([sm.shard_at(
        g, D, rank, sm.corpus_budgets([g], D, halo))], D).to(dev)
    out = sm.make_sharded_forward(_sharded_model(case, dev))(shard)
    return ((out - 0.3) ** 2).mean(), shard


def task_sharded_twice(work, plan, dev):
    """Each case of ``sharded.pt``: :func:`sharded_case` twice (a2a,
    eagerly, from the case's state); both runs' outputs and gradients."""
    cases = torch.load(work / "sharded.pt", weights_only=False)
    return {"sharded_twice": {
        name: [{k: r[k] for k in ("out", "grads")} for r in
               (sharded_case(case, dev), sharded_case(case, dev))]
        for name, case in cases.items()}}


TASKS = {"step": task_step, "time": task_time, "graphs": task_graphs,
         "ddi": task_ddi,
         "dist": task_dist, "measure": task_measure,
         "partial": task_partial, "halo": task_halo,
         "sharded": task_sharded, "sharded_time": task_sharded_time,
         "sharded_graphs": task_sharded_graphs,
         "sharded_overlap": task_sharded_overlap,
         "strainer": task_strainer, "rank_sum": task_rank_sum,
         "sharded_autograd": task_sharded_autograd,
         "sharded_twice": task_sharded_twice}


# --------------------------------------------------- started by the callers
def spawn_ranks(work, platform, ranks=2):
    """Start the worker's ranks on ``work``'s plan, each writing its
    output to rank<k>.out there; returns their processes."""
    return distributed.spawn_ranks(
        [sys.executable, str(Path(__file__).resolve()), str(work), platform],
        ranks, logs=work)


def wait_ranks(procs, work, timeout=300):
    """Wait for the ranks (stopping them all when one fails or
    ``timeout`` s pass); fail with every rank's output if one failed or
    they ran past ``timeout``; returns rank 0's results."""
    def logs():
        return "".join(f"--- rank {k}\n" + (Path(work) / f"rank{k}.out"
                                             ).read_text()[-4000:]
                       for k in range(len(procs)))
    try:
        rc = distributed.wait_ranks(procs, timeout)
    except TimeoutError as err:
        raise TimeoutError(f"{err}:\n{logs()}") from None
    if rc:
        raise RuntimeError(f"a rank exited with {rc}:\n{logs()}")
    return torch.load(Path(work) / "rank0.pt", weights_only=False)


def main(work: str, platform: str):
    # one thread a CPU rank: the test workers share the host, and a rank
    # whose threads wait for cores stalls its peer at every collective
    torch.set_num_threads(1 if platform == "cpu" else 2)
    work = Path(work)
    plan = json.loads((work / "plan.json").read_text())
    if plan.get("dump_after"):
        # every thread's stack in the rank's log, should the ranks still
        # run then (the caller stops them at its timeout)
        faulthandler.dump_traceback_later(plan["dump_after"])
    distributed.initialize_distributed(platform=platform)
    rank = distributed.world()[0]
    dev = distributed.rank_device(rank, platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in plan["tasks"]:
        print(f"rank {rank}: task {name}", flush=True)
        out.update(TASKS[name](work, plan, dev))
    if rank == 0:
        torch.save(out, work / "rank0.pt")
    # the tasks' trainers hold their step graphs in reference cycles
    distributed.shutdown()


def run(work: str, platform: str):
    """:func:`main`; a rank that fails leaves at once with exit code 1.
    A rank that raised would otherwise tear its process group down at
    interpreter exit while its peers wait in a collective for it, and an
    nccl group's teardown can wait for them in turn: the ranks would
    hang rather than fail."""
    try:
        main(work, platform)
    except BaseException:                # SystemExit from a check too
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
