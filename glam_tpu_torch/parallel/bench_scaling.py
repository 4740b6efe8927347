"""Scaling harness of data-parallel training: edges/s at 1 to N ranks, the
counterpart of the JAX package's ``parallel/bench_scaling.py``.

    python -m glam_tpu_torch.parallel.bench_scaling [--devices 1 2 4]
        [--graphs_per_device 512] [--n_iter 30] [--platform cpu]

prints one JSON line per rank count and a scaling-efficiency line.  Each
count runs the flagship at full width (TripletMessage, hid 60, 3 steps,
e_dim 1024, GlobalPool5, no noise; Adam, mse) on ``graphs_per_device``
molecules a rank, one process per rank (``parallel/data_parallel.py``),
on the cards (``cuda:(rank % cards)``) unless ``--platform cpu``.  On
the cards a step is the replay of its CUDA graph (one process:
``StepGraphs``; ranks: ``RankStepGraphs`` in their backend's design,
``distributed.step_graphs_for``), and the eager step's figures stand
beside it (``eager_edges_per_sec``, ``eager_step_ms``), timed in turns
(eager, replayed, replayed, eager); on the CPU the steps run eagerly.
Ranks
that share a card are time-sliced on it, so their rate is no scaling
number.  :func:`measure` starts the ranks as processes of this module
with the ``GLAM_*`` variables set (``distributed.spawn_ranks``); such a
process measures as its rank.

    python -m glam_tpu_torch.parallel.bench_scaling --analytic

prints :func:`analytic`, the JAX package's model of the node-sharded
tower's compute against its halo traffic (one JSON line a shard count),
at an H100's rates, then the card's name and power limit
(``nvidia-smi``) where there is a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch

SMILES = ("CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
          "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "Clc1cc2c(Oc3ccccc3C3CN(CC32)C)cc1")


def _graphs(n: int):
    from ..data.datasets import featurize_smiles
    from ..data.graph import GraphArrays
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        x, s, r, e = featurize_smiles(SMILES[i % len(SMILES)])
        out.append(GraphArrays(x, e, s, r, np.asarray([rng.randn()],
                                                      np.float32)))
    return out


def _measure_rank(n_devices: int, graphs_per_device: int, n_iter: int,
                  platform: str) -> dict:
    """This rank's part of :func:`measure`, in a process group of
    ``n_devices`` ranks (or alone for 1)."""
    from ..data.batching import GraphLoader
    from ..nn.model import Architecture, ModelConfig
    from ..train.optim import make_optimizer
    from ..train.trainer import make_loss_fn
    from . import data_parallel, distributed

    rank, ranks = distributed.world()
    if ranks != n_devices:
        raise RuntimeError(f"measure({n_devices}) in a group of {ranks}")
    dev = distributed.rank_device(rank, platform)
    graphs = _graphs(graphs_per_device * n_devices)
    batch = next(iter(GraphLoader(graphs, graphs_per_device * n_devices, 1,
                                  n_devices=n_devices, rank=rank)))
    batch = batch.to(dev)
    cfg = ModelConfig(mol_block="_TripletMessage", mol_readout="GlobalPool5",
                      hid_dim_alpha=4, e_dim=1024, message_steps=3,
                      max_nodes=40, graph_do="_None()", flat_do="_None()",
                      end_do="_None()", pre_act="CELU", graph_act="CELU",
                      flat_act="CELU")
    model = Architecture(cfg, torch.Generator().manual_seed(0)).to(dev)
    model.train()
    opt = make_optimizer("Adam", model.named_parameters(), 1e-3)
    loss_fn = make_loss_fn("regression", "mse", 1)
    if n_devices > 1:
        step = data_parallel.make_dp_train_step(model, loss_fn, opt)
    else:
        def step(parts):
            loss = loss_fn(model(*parts), parts[0].y, parts[0].graph_mask)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def seconds(fn):
        """Seconds of ``n_iter`` calls of ``fn``, after one."""
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        sync()
        return time.perf_counter() - t0

    eager = lambda: step((batch,))  # noqa: E731
    design = None
    if dev.type == "cuda":
        from ..train.step_graph import RankStepGraphs, StepGraphs
        host = (batch.to("cpu"),)
        gen = torch.Generator(dev)
        if n_devices > 1:
            backend = torch.distributed.get_backend()
            design = distributed.step_graphs_for(backend)[0]
            graphs = RankStepGraphs(step, None, dev, gen, design, 1,
                                    distributed.CAPTURE_ERROR_MODE[backend])
            replayed = lambda: graphs.train([host], False, [0])  # noqa: E731
        else:
            design = "one process"
            graphs = StepGraphs(lambda parts: step(parts), None, dev, gen)
            replayed = lambda: graphs.train([host], False)  # noqa: E731
        replayed()          # the warm-up, eager; the next call captures
        turns = [seconds(eager), seconds(replayed), seconds(replayed),
                 seconds(eager)]
        eager_s, replayed_s = turns[0] + turns[3], turns[1] + turns[2]
    else:
        eager_s = replayed_s = seconds(eager)
    edges = float(batch.num_real_edges)
    if n_devices > 1:        # the slowest rank's time, every rank's edges
        every = [None] * n_devices
        torch.distributed.all_gather_object(every,
                                            (eager_s, replayed_s, edges))
        eager_s = max(e[0] for e in every)
        replayed_s = max(e[1] for e in every)
        edges = sum(e[2] for e in every)
    calls = n_iter * (2 if dev.type == "cuda" else 1)
    return {"devices": n_devices, "platform": dev.type,
            "step_graphs": design,
            "edges_per_sec": edges * calls / replayed_s,
            "step_ms": replayed_s / calls * 1e3,
            "eager_edges_per_sec": edges * calls / eager_s,
            "eager_step_ms": eager_s / calls * 1e3}


def measure(n_devices: int, graphs_per_device: int = 512, n_iter: int = 30,
            platform: str = "cuda") -> dict:
    """{devices, platform, step_graphs, edges_per_sec, step_ms,
    eager_edges_per_sec, eager_step_ms} of data-parallel training steps
    over ``n_devices`` ranks (the first two replayed on the cards).  Inside a process group of
    ``n_devices`` ranks it measures as this rank; else it runs alone (1)
    or starts the ranks (this module's ``main``) and returns rank 0's
    result."""
    from . import distributed
    if n_devices == 1 or distributed.world()[1] == n_devices:
        return _measure_rank(n_devices, graphs_per_device, n_iter, platform)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        rc = distributed.wait_ranks(distributed.spawn_ranks(
            [sys.executable, "-m", "glam_tpu_torch.parallel.bench_scaling",
             "--devices", str(n_devices), "--graphs_per_device",
             str(graphs_per_device), "--n_iter", str(n_iter), "--platform",
             platform, "--out", out], n_devices, logs=tmp))
        if rc:
            logs = "".join(open(os.path.join(tmp, f"rank{k}.out")).read()
                           for k in range(n_devices))
            raise RuntimeError(f"measure({n_devices}): a rank exited with "
                               f"{rc}:\n{logs[-4000:]}")
        with open(out) as f:
            return json.load(f)


def _rank_main(args):
    """One rank of a job that :func:`measure` started: measures its
    count with the others, rank 0 writes the result to ``--out``."""
    from . import distributed
    distributed.initialize_distributed(platform=args.platform)
    result = _measure_rank(args.devices[0], args.graphs_per_device,
                           args.n_iter, args.platform)
    if distributed.world()[0] == 0:
        with open(args.out, "w") as f:
            json.dump(result, f)
    torch.distributed.destroy_process_group()
    return [result]


# NVIDIA's H100 SXM data sheet: NVLink 900 GB/s a card, both directions
# together (450 GB/s each way); 67 TFLOP/s float32 outside the tensor
# cores (the port's matmuls run float32, TF32 off)
H100_LINK_BYTES_PER_S = 4.5e11
H100_F32_FLOPS = 6.7e13


def analytic(L: int = 900, C: int = 60, heads: int = 3, steps: int = 3,
             shard_counts=(2, 4, 8), band: int = 6,
             long_range_frac: float = 0.05,
             link_bytes_per_sec: float = H100_LINK_BYTES_PER_S,
             flops_per_sec: float = H100_F32_FLOPS, seed: int = 0,
             fusion_nm: int = 40) -> List[dict]:
    """The analytic compute/communication model of a sharded protein
    tower's training step, the JAX package's ``analytic`` with its
    arithmetic unchanged and the rates given (default: an H100's, each
    one way of its links and its float32 rate; see the constants above).

    An L-residue contact-map-like graph (backbone, banded contacts and
    ``long_range_frac`` random long-range ones) is partitioned by
    ``split_large_graph`` and ``build_halo_exchange``; for each shard
    count, a shard's step: the matmul FLOPs of a TripletMessage tower
    (forward and backward ~ 3x the forward), the bytes its a2a halo
    receives (projected rows and attention scalars, both ways), the
    efficiency t_comp / (t_comp + t_comm) without overlap and with the
    work that does not wait on the halo hidden behind it, and the same
    for the ring plan.  Values unrounded."""
    from .graph_partition import (build_halo_exchange,
                                  build_halo_exchange_ring,
                                  split_large_graph)

    rng = np.random.RandomState(seed)
    snd, rcv = [], []
    for i in range(L - 1):  # backbone i <-> i+1
        snd += [i, i + 1]
        rcv += [i + 1, i]
    for i in range(L):      # banded contacts
        for j in range(i + 2, min(L, i + band + 1)):
            snd += [i, j]
            rcv += [j, i]
    for _ in range(int(long_range_frac * L)):  # long-range contacts
        i, j = rng.randint(0, L, 2)
        if abs(i - j) > band:
            snd += [i, j]
            rcv += [j, i]
    snd = np.asarray(snd, np.int32)
    rcv = np.asarray(rcv, np.int32)
    E = len(snd)
    nodes = rng.randn(L, 49).astype(np.float32)
    edges = rng.randn(E, 8).astype(np.float32)
    out = []
    for D in shard_counts:
        nsh, esh, sg, rl, emask = split_large_graph(nodes, edges, snd,
                                                    rcv, D)
        n_local, e_local = nsh.shape[1], esh.shape[1]
        _, send_mask, _, H = build_halo_exchange(sg, emask, n_local)
        HC = heads * C
        fwd = (n_local * C * HC * 2          # xp = x @ wn
               + e_local * 8 * HC * 2        # eh = e @ we
               + 2 * n_local * HC * 2        # a_i, a_j
               + e_local * HC * 2            # a_e
               + e_local * heads * C * 3     # alpha * eh * xh
               + n_local * HC * C * 2        # aggr @ wscale
               + n_local * C * 3 * C * 2 * 2   # GRU's two matmuls
               + fusion_nm * n_local * C * 2)  # the pair fusion's product
        flops_step = 3 * fwd * steps
        # work that does not wait on the halo: eh, a_i, a_e in every
        # step; the previous step's fusion behind the next exchange
        ov_core = e_local * 8 * HC * 2 + n_local * HC * 2 + e_local * HC * 2
        ov_fusion = fusion_nm * n_local * C * 2
        ov_step = 3 * (ov_core * steps + ov_fusion * max(steps - 1, 0))
        bytes_fwd = D * H * (heads * C + heads) * 4
        bytes_step = 2 * bytes_fwd * steps   # the backward's a2a too
        t_comp = flops_step / flops_per_sec
        t_comm = bytes_step / link_bytes_per_sec
        t_ov = ov_step / flops_per_sec
        _, budgets, _ = build_halo_exchange_ring(sg, emask, n_local)
        ring_rows = int(sum(budgets))
        ring_step = 2 * ring_rows * (heads * C + heads) * 4 * steps
        t_ring = ring_step / link_bytes_per_sec
        out.append({
            "shards": D, "L": L, "edges": E, "halo_budget_H": int(H),
            "real_halo_rows": int(send_mask.sum()),
            "flops_per_shard_step": int(flops_step),
            "link_bytes_per_shard_step": int(bytes_step),
            "t_compute_us": t_comp * 1e6,
            "t_comm_us": t_comm * 1e6,
            "predicted_efficiency": t_comp / (t_comp + t_comm),
            "t_overlap_us": t_ov * 1e6,
            "overlap_predicted_efficiency":
                t_comp / (t_comp + max(0.0, t_comm - t_ov)),
            "ring_halo_rows": ring_rows,
            "ring_link_bytes_per_shard_step": int(ring_step),
            "ring_t_comm_us": t_ring * 1e6,
            "ring_predicted_efficiency": t_comp / (t_comp + t_ring),
            "ring_overlap_predicted_efficiency":
                t_comp / (t_comp + max(0.0, t_ring - t_ov)),
        })
    return out


def card_line() -> str:
    """The card's ``name, power limit`` from ``nvidia-smi``, or why there
    is none."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no card: nvidia-smi gave no name and power limit"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=None)
    p.add_argument("--graphs_per_device", type=int, default=512)
    p.add_argument("--n_iter", type=int, default=30)
    p.add_argument("--platform", default="cuda",
                   help="'cpu' runs gloo ranks on the CPU")
    p.add_argument("--out", default=None,
                   help="where a rank of measure()'s job writes rank 0's "
                        "result")
    p.add_argument("--analytic", action="store_true",
                   help="print the node-sharded tower's analytic "
                        "compute/halo model at an H100's rates instead of "
                        "measuring")
    args = p.parse_args(argv)
    if args.analytic:
        rows = analytic()
        for row in rows:
            print(json.dumps(row))
        print(f"rates: links {H100_LINK_BYTES_PER_S:.3e} B/s, float32 "
              f"{H100_F32_FLOPS:.3e} FLOP/s (H100 SXM data sheet, at 700 W);"
              f" card: {card_line()}")
        return rows
    from .distributed import ENV_PROCESS_ID
    if ENV_PROCESS_ID in os.environ:
        return _rank_main(args)
    avail = ((os.cpu_count() or 1) if args.platform == "cpu"
             else torch.cuda.device_count())
    counts: List[int] = args.devices or [d for d in (1, 2, 4, 8)
                                         if d <= avail]
    results = []
    for d in counts:
        r = measure(d, args.graphs_per_device, args.n_iter, args.platform)
        results.append(r)
        print(json.dumps(r))
    if len(results) > 1:
        base = results[0]["edges_per_sec"] / results[0]["devices"]
        eff = (results[-1]["edges_per_sec"] / results[-1]["devices"]) / base
        print(json.dumps({"metric": "scaling_efficiency", "value": eff,
                          "from_devices": results[0]["devices"],
                          "to_devices": results[-1]["devices"]}))
    return results


if __name__ == "__main__":
    main()
