"""One rank of the port's data-parallel and halo checks, started by
``tests/test_torch_port_dp.py`` and ``tests/test_torch_port_partition.py``
(gloo ranks on the CPU), by ``tests/test_torch_port_cuda.py`` and by
``chip_smoke.py`` (gloo ranks sharing one card), with ``GLAM_COORDINATOR``,
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
           first global batch of the training loader, and each rank's
           kernel launches in that step;
  time     on the card, each rank's: the first config's step (median
           host ms of 20, the profile's busy ms), the gradient
           all-reduce's buffer (floats, median ms of 20) and, with
           ``halo.pt``, the v1 and v2 halo steps' median ms;
  ddi      a 1-epoch DDI pair trainer's per-epoch losses;
  dist     process_shard, global_mesh, the rank count and the backend;
  measure  bench_scaling.measure(ranks, graphs_per_device=8, n_iter=2);
  partial  each rank's state after one make_dp_train_step SGD step of
           PARTIAL_LAYERS linear layers, rank k's forward reaching layer
           k alone (so each has a gradient on one rank only);
  halo     the v1 and v2 halo message steps on this rank's shard of
           ``halo.pt`` (parameters, the split graph and the v2 plan),
           every rank's output gathered, and each rank's launches.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
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


def step_and_eval(tr: Trainer):
    """The merged evaluation from the current weights, then one step on
    the first batch: {out, y, loss, state, launches (of the step)}."""
    out, y, loss = tr._gather("valid")
    tr.model.train()
    batch = tr._to_device(next(iter(tr.train_loader)))
    before = launch_counts()
    tr.train_step(batch)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    state = {k: v.detach().cpu().clone()
             for k, v in tr.model.state_dict().items()}
    return {"out": out, "y": y, "loss": loss, "state": state,
            "launches": launches}


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


def task_time(work, plan, dev):
    from chip_smoke import print_profile
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
    got = {"host_ms": _median_ms(step),
           "busy": print_profile(f"rank {rank} data-parallel step", step)}
    params = [p for p in tr.model.parameters() if p.requires_grad]
    stats = data_parallel.running_stats(tr.model)
    # make_dp_train_step's buffer: the gradients, the running statistics,
    # a flag a parameter and the loss
    n = sum(p.numel() for p in params) + sum(b.numel() for b in stats) \
        + len(params) + 1
    flat = torch.zeros(n, device=dev)
    got["all_reduce_floats"] = n
    got["all_reduce_ms"] = _median_ms(
        lambda: distributed.all_reduce_sum(flat))
    if (work / "halo.pt").exists():
        v1, v2 = _halo_steps(work, dev)
        got["halo_ms"] = [_median_ms(v1), _median_ms(v2)]
    print(f"rank {rank}: {torch.distributed.get_backend()} on {dev}: one "
          f"data-parallel step host_ms={got['host_ms']:.4f} busy_ms="
          f"{got['busy']['busy_ms']:.4f}; all_reduce of {n} floats "
          f"all_reduce_ms={got['all_reduce_ms']:.4f}", flush=True)
    return {"time": _by_rank(got)}


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
    return {"partial": _by_rank({k: v.cpu()
                                 for k, v in model.state_dict().items()})}


def _halo_steps(work, dev):
    """This rank's v1 and v2 halo steps on its shard of ``halo.pt``, as
    calls of no arguments."""
    from glam_tpu_torch.parallel import graph_partition as gp
    rank = distributed.world()[0]
    h = torch.load(work / "halo.pt")
    p = {k: v.to(dev) for k, v in h["params"].items()}
    s = {k: v[rank].to(dev) for k, v in h.items() if k != "params"}
    v1, v2 = gp.make_halo_message_step(), gp.make_halo_message_step_v2()
    return (lambda: v1(p, s["nodes"], s["edges"], s["senders_global"],
                       s["receivers"], s["edge_mask"]),
            lambda: v2(p, s["nodes"], s["edges"], s["senders_local"],
                       s["receivers"], s["edge_mask"], s["send_idx"]))


def task_halo(work, plan, dev):
    before = launch_counts()
    v1, v2 = (step() for step in _halo_steps(work, dev))
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return {"halo": {"v1": distributed.all_gather(v1).cpu(),
                     "v2": distributed.all_gather(v2).cpu(),
                     "launches": _by_rank(launches)}}


TASKS = {"step": task_step, "time": task_time, "ddi": task_ddi,
         "dist": task_dist, "measure": task_measure,
         "partial": task_partial, "halo": task_halo}


# --------------------------------------------------- started by the callers
def spawn_ranks(work, platform, ranks=2):
    """Start the worker's ranks on ``work``'s plan, each writing its
    output to rank<k>.out there; returns their processes."""
    return distributed.spawn_ranks(
        [sys.executable, str(Path(__file__).resolve()), str(work), platform],
        ranks, logs=work)


def wait_ranks(procs, work, timeout=300):
    """Wait for the ranks (stopping them all when one fails or
    ``timeout`` s pass); fail with every rank's output if one failed;
    returns rank 0's results."""
    rc = distributed.wait_ranks(procs, timeout)
    if rc:
        logs = "".join(f"--- rank {k}\n" + (Path(work) / f"rank{k}.out"
                                              ).read_text()[-4000:]
                       for k in range(len(procs)))
        raise RuntimeError(f"a rank exited with {rc}:\n{logs}")
    return torch.load(Path(work) / "rank0.pt", weights_only=False)


def main(work: str, platform: str):
    torch.set_num_threads(2)
    work = Path(work)
    plan = json.loads((work / "plan.json").read_text())
    distributed.initialize_distributed(platform=platform)
    rank = distributed.world()[0]
    dev = distributed.rank_device(rank, platform)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name in plan["tasks"]:
        out.update(TASKS[name](work, plan, dev))
    if rank == 0:
        torch.save(out, work / "rank0.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
