#!/usr/bin/env python3
"""The largest protein one training step of the giant demo's
configuration takes, dense on one card and node-sharded over N cards:

    python scripts/largest_protein_torch.py --dense
    python scripts/largest_protein_torch.py --shards 4

The configuration is ``scripts/giant_protein_demo_torch.py``'s (a
TripletMessage molecule tower, a GCN protein tower with GlobalLAPool,
hid 60, 3 steps, e_dim 64, Adam, a pair batch of 2), the proteins its
generator's at L residues (seeds 0 and 1).  L starts at ``--start``
(3,000) and grows by ``--factor`` (4); each L runs in a process of its
own (``--shards``: N rank processes, one card each): it builds the two
proteins, plans them (sharded: ``corpus_budgets``, ``shard_at``,
``pack_shards``, timed as host planning), and takes one eager Adam step,
then a second, timed.  The growth stops at the first L whose step runs
out of device memory (reported as such, never hidden), or whose host
planning took more than ``--plan_limit_s`` seconds, or, before an L is
started, when the planning measured so far, grown as it grew from the
L before, says that L's would take more than the limit.  Each L prints
one line; the last line of the output is one JSON object of them all,
with the card's name and power limit.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

OOM_EXIT = 3


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no card"


def build(L: int, shards: int, dev):
    """(model, molecule batch [2 pairs], labels, proteins) of the giant
    demo's configuration at L residues."""
    import torch
    import giant_protein_demo_torch as giant
    from glam_tpu_torch.data.graph import pad_graphs
    from glam_tpu_torch.nn.model import PairArchitecture, model_config_from_args
    from glam_tpu_torch.train.pair_trainer import _set_pair_max_nodes
    pros = [giant.synth_protein(L, s) for s in (0, 1)]
    mols = [giant.synth_mol(i, float(i % 2)) for i in (0, 1)]
    args = dict(giant.trainer_args(shards, 2), task="pair_binary",
                num_tasks=1, out_dim=2, end_norm="_None")
    overrides = {"mol_in_dim": 15, "mol_edge_in_dim": 4, "pro_in_dim": 49,
                 "pro_edge_in_dim": 8, "out_dim": 2, "end_norm": "_None"}
    _set_pair_max_nodes(overrides, list(zip(mols, pros)), hetero=True)
    cfg = model_config_from_args(args, **overrides)
    model = PairArchitecture(cfg, hetero=True, generator=torch.Generator()
                             .manual_seed(7)).to(dev)
    nb = 8 * -(-max(m.nodes.shape[0] for m in mols) // 8) + 8
    eb = 8 * -(-max(m.senders.shape[0] for m in mols) // 8) + 8
    mol_b = pad_graphs(mols, 2, 2 * nb, 2 * eb, num_tasks=1).to(dev)
    y = torch.tensor([0.0, 1.0], device=dev)
    return model, mol_b, y, pros


def one_dense(L: int, platform: str) -> dict:
    import torch
    from glam_tpu_torch.data.graph import pad_graphs
    from glam_tpu_torch.train.sharded_pair_trainer import pair_losses
    dev = torch.device("cuda:0" if platform == "cuda" else "cpu")
    t0 = time.perf_counter()
    model, mol_b, y, pros = build(L, 1, dev)
    n = 8 * -(-(sum(p.nodes.shape[0] for p in pros) + 1) // 8)
    e = 8 * -(-sum(p.senders.shape[0] for p in pros) // 8) + 8
    pro_b = pad_graphs(pros, 2, n, e, num_tasks=1).to(dev)
    build_s = time.perf_counter() - t0
    loss_fn = pair_losses("pair_binary")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(dev).manual_seed(8)    # RReLU's and Dropout's

    def step():
        loss = loss_fn(model(mol_b, pro_b, generator=gen)[:2], y).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss

    return {"build_s": build_s, **timed_steps(step, dev)}


def timed_steps(step, dev) -> dict:
    """One step, then a second timed (host ms between synchronisations),
    with the peak device memory over both (0 on the CPU)."""
    import torch
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    loss = float(step())
    sync()
    t0 = time.perf_counter()
    step()
    sync()
    gib = lambda f: f(dev) / 2**30 if cuda else 0.0  # noqa: E731
    return {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
            "peak_allocated_gib": gib(torch.cuda.max_memory_allocated),
            "peak_reserved_gib": gib(torch.cuda.max_memory_reserved)}


def one_sharded(L: int, shards: int, platform: str) -> dict:
    import torch
    from glam_tpu_torch.parallel import distributed
    from glam_tpu_torch.parallel import sharded_model as sm
    from glam_tpu_torch.parallel.data_parallel import broadcast_state
    from glam_tpu_torch.train.sharded_pair_trainer import pair_losses
    rank = distributed.world()[0]
    dev = distributed.rank_device(rank, platform)
    t0 = time.perf_counter()
    model, mol_b, y, pros = build(L, shards, dev)
    broadcast_state(model)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    budgets = sm.corpus_budgets(pros, shards, "auto")
    shard = sm.pack_shards([sm.shard_at(p, shards, rank, budgets)
                            for p in pros], shards).to(dev)
    plan_s = time.perf_counter() - t0
    fwd = sm.make_sharded_pair_forward(model)
    loss_fn = pair_losses("pair_binary")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    w = torch.ones(2, device=dev)
    # the trainer's noise: the protein tower's RReLU slopes (graph
    # dropout at rate 0) from a CPU generator, the molecule tower's own
    cfg, pro_gen = model.cfg, torch.Generator().manual_seed(8)
    noise = tuple(t.to(dev) for t in sm.local_noise([
        sm.make_stochastic_inputs(pro_gen, shards * shard.n_local,
                                  cfg.hid_dim, cfg.message_steps, shards,
                                  rate=0.0) for _ in pros], rank))
    gen = torch.Generator(dev).manual_seed(8)

    def step():
        loss = loss_fn(fwd(mol_b, shard, gen, noise, bn_weight=w), y).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        sm.sync_grads(model)
        opt.step()
        return loss

    torch.distributed.barrier()
    got = {"build_s": build_s, "plan_s": plan_s, "halo": budgets[4],
           "n_local": shard.n_local, "halo_rows": shard.halo_rows,
           "edge_slots": int(shard.edges.shape[0]), **timed_steps(step, dev)}
    every = [None] * shards
    torch.distributed.all_gather_object(every, got)
    return {"by_rank": every}


def one_sharded_rank(L: int, shards: int, platform: str) -> dict:
    """:func:`one_sharded` as a rank of the group it joins and leaves."""
    from glam_tpu_torch.parallel import distributed
    distributed.initialize_distributed(num_processes=shards,
                                       platform=platform)
    got = one_sharded(L, shards, platform)
    distributed.shutdown()
    return got


def child(args) -> None:
    """One L in this process (a rank of it with ``--shards``): prints
    ``RESULT <json>``; exits OOM_EXIT on running out of device memory."""
    import torch
    try:
        got = (one_dense(args.one_L, args.platform) if args.shards == 1
               else one_sharded_rank(args.one_L, args.shards,
                                     args.platform))
        print("RESULT " + json.dumps(dict(got, ok=True)), flush=True)
    except torch.OutOfMemoryError as err:
        print("RESULT " + json.dumps({"ok": False, "reason": "out of device "
                                      "memory: " + str(err).splitlines()[0]}),
              flush=True)
        sys.stdout.flush()
        os._exit(OOM_EXIT)        # a rank's peers wait in a collective
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def run_one(L: int, shards: int, timeout: float, platform: str) -> dict:
    """L's process (or ranks), and what they printed."""
    from glam_tpu_torch.parallel import distributed
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one_L", str(L),
           "--shards", str(shards), "--platform", platform]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as logs:
        if shards == 1:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
            rc, outs = proc.returncode, [proc.stdout + proc.stderr]
        else:
            try:
                rc = distributed.wait_ranks(distributed.spawn_ranks(
                    cmd, shards, logs=logs), timeout)
            except TimeoutError:
                rc = -1
            outs = [(Path(logs) / f"rank{k}.out").read_text()
                    for k in range(shards)]
    wall = time.perf_counter() - t0
    results = [json.loads(line[7:]) for out in outs
               for line in out.splitlines() if line.startswith("RESULT ")]
    ok = [r for r in results if r.get("ok")]
    if rc == 0 and ok:
        return dict(ok[0], rc=0, wall_s=wall)
    oom = [r for r in results if not r.get("ok")]
    if oom:
        return dict(oom[0], rc=rc, wall_s=wall)
    return {"ok": False, "rc": rc, "wall_s": wall,
            "reason": "failed (not out of memory): " + outs[0][-2000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense", action="store_true",
                    help="the dense model on cuda:0")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--start", type=int, default=3000)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--max_L", type=int, default=50_000_000)
    ap.add_argument("--plan_limit_s", type=float, default=600.0)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds an L may take in all")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="'cpu' runs the same steps on the CPU (gloo ranks)"
                         ": no memory figures")
    ap.add_argument("--one_L", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one_L is not None:
        child(args)
        return 0
    if args.dense == (args.shards > 1):
        ap.error("give --dense or --shards N > 1")
    card = card_line()
    label = "dense, one card" if args.dense else f"{args.shards} shards"
    rows, L, plans = [], args.start, []
    while L <= args.max_L:
        if len(plans) > 1:
            growth = plans[-1] / max(plans[-2], 1e-9)
            if plans[-1] * growth > args.plan_limit_s:
                rows.append({"L": L, "ok": None, "reason": (
                    f"not run: its host planning would take about "
                    f"{plans[-1] * growth:.0f} s (the last L's "
                    f"{plans[-1]:.1f} s x its growth {growth:.2f}), over "
                    f"the limit of {args.plan_limit_s:.0f} s")})
                print(f"largest L [{label}] L={L}: {rows[-1]['reason']}",
                      flush=True)
                break
        got = run_one(L, args.shards, args.timeout, args.platform)
        row = {"L": L, **got}
        if got.get("by_rank"):
            ranks = got["by_rank"]
            row.update(plan_s=max(r["plan_s"] for r in ranks),
                       peak_allocated_gib=max(r["peak_allocated_gib"]
                                              for r in ranks),
                       step_ms=max(r["step_ms"] for r in ranks))
            plans.append(row["plan_s"])
        rows.append(row)
        brief = {k: v for k, v in row.items() if k != "by_rank"}
        print(f"largest L [{label}] L={L}: {json.dumps(brief)} ({card})",
              flush=True)
        if not got.get("ok"):
            break
        if row.get("plan_s", 0.0) > args.plan_limit_s:
            row["stop"] = (f"host planning {row['plan_s']:.1f} s, over the "
                           f"limit of {args.plan_limit_s:.0f} s")
            break
        L *= args.factor
    took = [r["L"] for r in rows if r.get("ok")]
    stop = rows[-1]
    print(f"largest L [{label}]: {max(took) if took else None} residues "
          f"took a step; stopped at L={stop['L']}: "
          f"{stop.get('stop') or stop.get('reason') or 'the --max_L bound'}"
          f" ({card})", flush=True)
    print(json.dumps({"label": label, "largest_L": max(took) if took
                      else None, "rows": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
