#!/usr/bin/env python3
"""The giant-protein regime that ``--pro_shards`` exists for, in the
PyTorch port: the counterpart of ``scripts/giant_protein_demo.py``.

Builds an in-memory DTI corpus whose proteins are L = 3,000-residue
contact-map graphs (banded contacts and 5% random long-range pairs, the
JAX script's generator from the same seeds), and trains the port's
``ShardedPairTrainer`` on it over ``--shards`` ranks, one process each,
with ``--halo auto`` and a pair batch:

    python scripts/giant_protein_demo_torch.py [--shards 8] [--L 3000]
        [--pairs 12] [--pair_batch 2] [--platform cpu]

Without ``--platform cpu`` rank r drives ``cuda:(r % cards)`` (nccl when
every rank has a card of its own, else gloo: ``parallel/distributed.py``).
Rank 0 prints the corpus line, the plan line (budgets, halo plan, a2a
and ring budgets, set-up seconds), the halo rows and bytes a rank
receives in an exchange, each epoch's wall seconds, the validation loss
and AUC, and each rank's step: host ms eager and (under nccl, where the
trainer replays a CUDA graph a step) replayed in turns, and on a card
the busy ms of one profiled step of each.  The last line is one JSON
object of the same figures.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MOL_SMILES = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
              "c1ccncc1", "CCO", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
              "c1ccc2[nH]ccc2c1"]


def synth_protein(L: int, seed: int):
    """An L-residue contact map from ``seed``: chain and |i - j| <= 6
    contacts both ways, then 0.05 L random pairs farther apart (the JAX
    script's generator, draw for draw and edge for edge; its lists built
    here by numpy)."""
    from glam_tpu_torch.data.graph import GraphArrays
    rng = np.random.RandomState(seed)
    i = np.arange(L - 1)
    chain = np.stack([i, i + 1, i + 1, i], 1).reshape(-1, 2)  # (s, r)
    band = []                     # for each i, j = i+2 .. i+6, in order
    for d in range(2, 7):
        i = np.arange(max(L - d, 0))
        band.append(np.stack([i, i + d], 1))
    band = np.concatenate(band) if band else np.zeros((0, 2), np.int64)
    band = band[np.lexsort((band[:, 1], band[:, 0]))]
    band = np.stack([band, band[:, ::-1]], 1).reshape(-1, 2)
    far = []
    for _ in range(int(0.05 * L)):
        a, b = rng.randint(0, L, 2)
        if abs(a - b) > 6:
            far += [(a, b), (b, a)]
    pairs = np.concatenate([chain, band, np.asarray(far, np.int64)
                            .reshape(-1, 2)])
    return GraphArrays(
        nodes=rng.randn(L, 49).astype(np.float32),
        edges=rng.randn(len(pairs), 8).astype(np.float32),
        senders=pairs[:, 0].astype(np.int32),
        receivers=pairs[:, 1].astype(np.int32),
        y=np.zeros(1, np.float32), smi=f"GIANT{seed}")


def synth_mol(seed: int, label: float):
    """A small molecule featurized by the port, labelled ``label``."""
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.data.graph import GraphArrays
    x, s, r, e = smiles_to_arrays(MOL_SMILES[seed % len(MOL_SMILES)])
    return GraphArrays(nodes=x, edges=e, senders=s, receivers=r,
                       y=np.asarray([label], np.float32), smi="")


class Corpus:
    """The trainer's dataset: ``pairs`` pairs over three proteins, the
    last 4 split into validation and test."""

    num_node_features, num_edge_features = 15, 4
    pro_num_node_features, pro_num_edge_features = 49, 8
    class_weights = None

    def __init__(self, L: int, pairs: int):
        pros = [synth_protein(L, s) for s in range(3)]
        every = [(synth_mol(i, float(i % 2)), pros[i % len(pros)])
                 for i in range(pairs)]
        self.train = every[:pairs - 4]
        self.val = every[pairs - 4:pairs - 2]
        self.test = every[pairs - 2:]


def trainer_args(shards: int, pair_batch: int, epochs: int = 2) -> dict:
    """The JAX script's trainer arguments: a TripletMessage molecule
    tower, a GCN protein tower with GlobalLAPool, hid_dim_alpha 4 (hid
    60, the flagship's width), 3 steps, e_dim 64, ``--halo auto``."""
    return {"dataset": "bindingdb_c", "pro_shards": shards,
            "epochs": epochs, "lr": 1e-3, "seed": 7, "e_dim": 64,
            "hid_dim_alpha": 4, "message_steps": 3,
            "mol_block": "_TripletMessage", "pro_block": "_GCNConv",
            "pro_readout": "GlobalLAPool", "mol_readout": "GlobalPool5",
            "halo": "auto", "pair_batch": pair_batch}


def busy_ms(fn) -> float:
    """The summed duration of the device kernels of one call of ``fn``
    (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def host_ms(fn, reps: int, cuda: bool) -> float:
    """Median host ms of ``fn()``, each call between two synchronisations
    with the card."""
    import torch
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_turns(tr, reps: int):
    """This rank's step on the first training chunk: host ms eager and,
    through the trainer's graphs, replayed, in turns (eager, replayed,
    replayed, eager); busy ms of each on a card.  The replays step the
    weights too, so this runs after training."""
    import torch
    cuda = tr.device.type == "cuda"
    item = tr._item(tr.splits["train"][:tr.B], train=True)
    tr.model.train(tr.stochastic)
    eager = lambda: tr._train(tr._on_device(item))  # noqa: E731
    replay = (lambda: tr.train_step(item)) if tr.step_graphs else None
    for _ in range(2):
        eager()
        if replay:
            replay()
    order = ["eager", "replayed", "replayed", "eager"] if replay \
        else ["eager", "eager"]
    turns = {k: [] for k in order}
    for k in order:
        turns[k].append(host_ms(eager if k == "eager" else replay, reps,
                                cuda))
    out = {"turns": turns}
    if cuda:
        torch.distributed.barrier()
        torch.cuda.synchronize()
        out["busy_ms"] = {"eager": busy_ms(eager)}
        if replay:
            torch.distributed.barrier()
            torch.cuda.synchronize()
            out["busy_ms"]["replayed"] = busy_ms(replay)
    return out


def rank_main(args) -> None:
    import torch
    from glam_tpu_torch.parallel import distributed
    platform = "cpu" if args.platform == "cpu" else "cuda"
    backend = distributed.initialize_distributed(num_processes=args.shards,
                                                 platform=platform)
    rank = distributed.world()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    demo(args, backend, rank, distributed.rank_device(rank, platform))
    # the trainer and its step graphs are gone with demo()'s frame
    distributed.shutdown()


def demo(args, backend, rank, dev) -> None:
    """This rank's part of the demo (see the module docstring)."""
    import torch
    from glam_tpu_torch.ops.kernels import launch_counts
    from glam_tpu_torch.train.sharded_pair_trainer import ShardedPairTrainer
    say = print if rank == 0 else (lambda *a, **k: None)
    t0 = time.time()
    ds = Corpus(args.L, args.pairs)
    E = ds.train[0][1].senders.shape[0]
    say(f"corpus: {args.pairs} pairs, protein L={args.L} ({E} edges each), "
        f"built in {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    tr = ShardedPairTrainer(trainer_args(args.shards, args.pair_batch,
                                         args.epochs), ds,
                            task="pair_binary", work_dir=args.work_dir,
                            device=dev)
    nb, eb, hb, ring, plan = tr._pro_budgets
    shard = tr._item(ds.train[:tr.B])[1]
    setup = time.time() - t0
    width = tr.cfg.hid_dim        # GCN exchanges xp [rows, hid]
    halo = [None] * args.shards
    torch.distributed.all_gather_object(halo, shard.halo_rows)
    say(f"plan: node_budget {nb} -> {shard.n_local}/shard, edge_budget "
        f"{eb}/shard, halo={tr.halo} (a2a budget {hb}, ring budgets "
        f"{list(ring)}), setup {setup:.1f}s", flush=True)
    say(f"halo: a rank receives {halo} rows (ranks 0..{args.shards - 1}) "
        f"an exchange of the {tr.B} pairs of a step, x {width} float32 = "
        f"{[r * width * 4 for r in halo]} bytes; 3 exchanges a forward, 3 "
        f"a backward; backend {backend}, step graphs "
        f"{tr.step_graphs is not None} ({tr.step_graphs_reason})",
        flush=True)
    ends = []
    valid = tr.valid_iterations

    def timed_valid(mode="valid"):
        out = valid(mode)
        ends.append(time.perf_counter())
        return out

    tr.valid_iterations = timed_valid
    before = launch_counts()
    t0 = time.perf_counter()
    tr.train()
    dt = time.perf_counter() - t0
    tr.valid_iterations = valid
    epochs = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    val_loss, val_m = tr.valid_iterations("valid")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the kernels' launches in training and the last validation, with the
    # trainer's steps and forwards over them
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    launches.update(steps=tr.steps, forwards=tr.forwards)
    by_rank = [None] * args.shards
    torch.distributed.all_gather_object(by_rank, launches)
    say(f"launches by rank (training and the last validation): "
        f"{json.dumps(by_rank)}", flush=True)
    n_steps = args.epochs * -(-len(ds.train) // args.pair_batch)
    say(f"trained {args.epochs} epochs ({n_steps} optimizer steps, "
        f"pair_batch={args.pair_batch}) in {dt:.1f}s over {args.shards} "
        f"ranks on {dev.type}; epoch wall s "
        f"{', '.join(f'{e:.3f}' for e in epochs)} (each with its "
        f"validation); val_loss={val_loss:.4f} "
        f"val_auc={val_m.get('auc')}", flush=True)
    steps = step_turns(tr, 10 if dev.type == "cuda" else 3)
    every = [None] * args.shards
    torch.distributed.all_gather_object(every, steps)
    for k, r in enumerate(every):
        busy = r.get("busy_ms")
        say(f"step rank {k}: host ms in turns " + ", ".join(
            f"{kind} {', '.join(f'{v:.4f}' for v in vals)}"
            for kind, vals in r["turns"].items())
            + (f"; busy ms {', '.join(f'{k2} {v:.4f}' for k2, v in busy.items())}"
               if busy else "; busy ms not measured (no card)")
            + ("" if tr.step_graphs else
               f"; no replay ({tr.step_graphs_reason})"), flush=True)
    say(json.dumps({
        "L": args.L, "shards": args.shards, "pairs": args.pairs,
        "pair_batch": args.pair_batch, "edges": int(E),
        "plan": {"node_budget": nb, "n_local": shard.n_local,
                 "edge_budget": eb, "a2a_budget": hb, "ring": list(ring),
                 "halo": tr.halo}, "setup_s": setup,
        "halo_rows": halo, "halo_bytes": [r * width * 4 for r in halo],
        "epoch_s": epochs, "train_s": dt, "val_loss": val_loss,
        "val_auc": val_m.get("auc"),
        "launches_by_rank": by_rank,
        "steps_by_rank": every, "backend": backend,
        "step_graphs": tr.step_graphs is not None}), flush=True)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--L", type=int, default=3000)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--pair_batch", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work_dir", default=None,
                    help="the trainer's run directory (default: a "
                         "temporary one, removed at the end)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds before the ranks are stopped")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    from glam_tpu_torch.parallel import distributed
    if distributed.ENV_PROCESS_ID in os.environ:
        rank_main(args)
        return 0
    if args.pairs < 5:
        raise SystemExit("--pairs must leave a training pair beside the 4 "
                         "of validation and test")
    if args.platform == "cuda":
        distributed.rank_device(0, "cuda")       # raises without a card
        from glam_tpu_torch.ops.kernels import build
        build.build()
    tmp = None
    if args.work_dir is None:
        tmp = tempfile.mkdtemp(prefix="giant_protein_demo_torch_")
        argv += ["--work_dir", tmp]
    try:
        procs = distributed.spawn_ranks(
            [sys.executable, str(Path(__file__).resolve()), *argv],
            args.shards)
        rc = distributed.wait_ranks(procs, args.timeout)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    if rc:
        print(f"giant_protein_demo_torch: a rank exited with {rc}",
              file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
