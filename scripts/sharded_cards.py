#!/usr/bin/env python3
"""The data-parallel and node-sharded steps over N ranks, one card each
(nccl), replayed as CUDA graphs with their collectives inside:

    python scripts/sharded_cards.py --ranks 4 [--parts dp,time,...]

Needs N CUDA cards.  Prints the cards' names and power limits first,
then, in order (``--parts`` picks some of them):
  dp       ``python -m glam_tpu_torch.run --n_devices N`` on the demo
           corpus (the flagship, one epoch, batch 64): the exit code, the
           final line, every rank's step graphs (the "whole" design: one
           graph a step or group, its all-reduce inside) and launches (A
           3 a forward, B 3 a step), and the wall seconds;
  time     the worker's dp ``time`` task (``tests/torch_port_dp_worker.py``;
           the smoke's full-width flagship, batch 64 over the ranks, SGD):
           each rank's step eager and replayed in turns with its busy ms,
           the gradient all-reduce under nccl and through a gloo group of
           the same ranks, and the v1 and v2 halo steps over N shards;
  cli      ``python -m glam_tpu_torch.run --pro_shards N`` on dti_demo
           (one epoch, a TripletMessage molecule tower and a GAT protein
           tower), with a2a and with ``--halo ring --pair_batch 4``: the
           same checks, launches A and C 3 a forward, B and C's backward
           3 a step;
  protein  the 1,000-residue synthetic protein of ``chip_smoke.py`` and
           the giant demo's 3,000-residue one at full width over N shards
           (worker tasks ``sharded``, ``sharded_time`` and
           ``sharded_graphs``; the 3,000-residue one captured only): the
           eager and the captured step's output
           and gradients against the dense model on cuda:0 (rtol/atol
           1e-4; rtol 2e-4 + atol 5e-5 x each leaf's scale), the launches
           of a replay, the ranks' parameters after Adam steps (eager;
           replayed), each rank's step, halo and collective times, the
           step's host ms eager and replayed in turns with its busy ms
           (with and without the collectives' kernels, profiled after a
           barrier); the halo/compute overlap on and off
           (``scripts/profile_overlap_torch.py``'s schedule, trace and
           A/B); and the dense model's step on cuda:0 (the same loss and
           Adam), host and busy ms, eager and replayed in turns;
  giant    ``scripts/giant_protein_demo_torch.py --shards N``;
  largest  ``scripts/largest_protein_torch.py --shards N``: the largest
           L of the giant demo's configuration one step takes over N
           shards (the dense one-card run is that script's ``--dense``);
  scaling  ``python -m glam_tpu_torch.parallel.bench_scaling --devices 1
           2 N`` (replayed steps, the eager ones beside them).
Exits non-zero on a failed check.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "scripts"))


PARTS = ("dp", "time", "cli", "protein", "giant", "largest", "scaling")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--parts", default=",".join(PARTS),
                   help=f"which of {', '.join(PARTS)} to run, in that "
                        "order (default: all)")
    p.add_argument("--plan_limit_s", type=float, default=600.0,
                   help="the largest-L growth's limit on host planning")
    args = p.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        p.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    import torch

    import chip_smoke as cs
    import torch_port_dp_worker as worker
    from glam_tpu_torch.parallel import distributed
    n = args.ranks
    if torch.cuda.device_count() < n:
        cs.fail(f"{n} ranks need {n} cards, have {torch.cuda.device_count()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, design, why = distributed.step_graphs_rule(
        "cuda", n, torch.cuda.device_count())
    sharded_design, _ = distributed.sharded_step_graphs_for(backend)
    print(f"{n} ranks: backend {backend}; step graphs {design} ({why}); "
          f"sharded steps {sharded_design}")
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        if "dp" in parts:
            flags = [a if a != str(cs.DP_RANKS) else str(n)
                     for a in cs.DP_ARGS]
            _, _, by_rank, steps, forwards, wall = cs.run_ranks_cli(
                tmp, flags, "dp_cards", graphs=design, ranks=n)
            cs.check_rank_counts("dp_cards", by_rank, {
                "triplet_fused_fwd": 3 * forwards,
                "triplet_fused_bwd": 3 * steps})
            print(f"run --n_devices {n}: launches exact on each of {n} "
                  f"ranks (A 3 x {forwards} forwards, B 3 x {steps} steps),"
                  f" wall_s={wall:.2f}")
        if "time" in parts:
            dp_time(tmp, n, card, cs, worker, torch)
        if "cli" in parts:
            sharded_cli(tmp, n, sharded_design, cs)
        if "protein" in parts:
            protein(tmp, n, dev, card, cs, worker, torch)
    if "giant" in parts:
        run_script(["giant_protein_demo_torch.py", "--shards", str(n)],
                   "giant_protein_demo_torch", card, cs, 1200)
    if "largest" in parts:
        run_script(["largest_protein_torch.py", "--shards", str(n),
                    "--plan_limit_s", str(args.plan_limit_s)],
                   "largest_protein_torch", card, cs, 3000)
    if "scaling" in parts:
        res = subprocess.run([sys.executable, "-m",
                              "glam_tpu_torch.parallel.bench_scaling",
                              "--devices", "1", "2", str(n)], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout[-3000:] + res.stderr[-3000:])
            cs.fail("bench_scaling --devices 1 2 4 failed")
        for line in res.stdout.strip().splitlines():
            print(f"bench_scaling --devices 1 2 {n}: {line} ({card})")


def run_script(argv, label, card, cs, timeout):
    """``python scripts/<argv>``: its output; fails on a nonzero exit."""
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / argv[0]),
                          *argv[1:]], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    for line in res.stdout.strip().splitlines():
        print(f"{label}: {line}")
    if res.returncode:
        print(res.stderr[-4000:])
        cs.fail(f"{' '.join(argv)} exited {res.returncode}")
    print(f"{label}: ({card})")


def dp_time(tmp, n, card, cs, worker, torch):
    """The worker's dp ``time`` task on the ranks (the smoke's flagship at
    full width, batch 64 over the ranks, SGD): each rank's step eager and
    replayed whole in turns, profiled after a barrier; the gradient
    all-reduce under nccl and, on the same ranks and buffer, through a
    gloo group; and the v1 and v2 halo steps over the n-shard plan."""
    work = Path(tmp) / "dp_time"
    work.mkdir()
    params, shards, _, _ = cs.halo_inputs(n)
    torch.save(dict(shards, params=params), work / "halo.pt")
    (work / "plan.json").write_text(json.dumps({
        "tasks": ["time"], "root": str(cs.demo_root(tmp)),
        "configs": {"flagship_demo": cs.DP_STEP_ARGS}, "dump_after": 420}))
    got = worker.wait_ranks(worker.spawn_ranks(work, "cuda", n), work,
                            timeout=480)
    for k in range(n):
        for line in (work / f"rank{k}.out").read_text().splitlines():
            if line.startswith(("rank ", "profile", "[distributed]")):
                print(f"  [rank {k}] {line}")
    cs.print_dp_times(got["time"], f"{n} nccl ranks, one card each; {card}")
    for k, r in enumerate(got["time"]):
        print(f"dp gradient all_reduce rank {k}: {r['all_reduce_floats']} "
              f"floats, nccl {r['all_reduce_ms']:.4f} ms, gloo (a group "
              f"of the same ranks, staged through the host) "
              f"{r['all_reduce_gloo_ms']:.4f} ms; halo steps v1 "
              f"{r['halo_ms'][0]:.4f} ms, v2 {r['halo_ms'][1]:.4f} ms; "
              f"medians of 20 ({card})")


def sharded_cli(tmp, n, sharded_design, cs):
    """``run --pro_shards n`` on dti_demo, a2a and ring."""
    for label, extra in (("a2a", []), ("ring", ["--halo", "ring",
                                                "--pair_batch", "4"])):
        flags = ["--epochs", "1", "--mol_block", "_TripletMessage",
                 "--pro_block", "_GATConv", "--pro_shards", str(n)] + extra
        _, _, by_rank, s, f, wall = cs.run_ranks_cli(
            tmp, flags, f"sharded_{label}", "bindingdb_c",
            graphs=sharded_design, ranks=n)
        cs.check_rank_counts(f"sharded_{label}", by_rank, {
            "triplet_fused_fwd": 3 * f, "triplet_fused_bwd": 3 * s,
            "segment_softmax_spmm_fwd": 3 * f,
            "segment_softmax_spmm_bwd": 3 * s})
        print(f"run --pro_shards {n} [{label}]: {s} steps, {f} forwards "
              f"a rank, launches exact on each of {n} ranks, "
              f"wall_s={wall:.2f}")


def protein(tmp, n, dev, card, cs, worker, torch):
    """The 1,000-residue protein and the giant demo's 3,000-residue one at
    full width over n shards: eager against dense, times, captured whole
    against dense, the overlap's three measurements, the dense step."""
    import profile_overlap_torch as overlap
    work = Path(tmp) / "protein"
    work.mkdir()
    cases = cs.sharded_protein_cases(overlap_ab=True)
    for name, case in cs.sharded_protein_cases(
            length=3000, giant=True, overlap_ab=True).items():
        cases[name] = dict(case, captured_only=True)   # no eager tasks
    torch.save(cases, work / "sharded.pt")
    (work / "plan.json").write_text(json.dumps(
        {"tasks": ["sharded", "sharded_time", "sharded_graphs"],
         "dump_after": 1140}))
    procs = worker.spawn_ranks(work, "cuda", n)
    dense = {name: cs.dense_pair_reference(case, dev)
             for name, case in cases.items()}
    got = worker.wait_ranks(procs, work, timeout=1200)
    for k in range(n):
        for line in (work / f"rank{k}.out").read_text().splitlines():
            if line.startswith(("profile", "[distributed]", "overlap")):
                print(f"  [rank {k}] {line}")
    for name in got["sharded"]:
        for halo in ("a2a", "ring"):
            out_err, grad_err = cs.hold_sharded(
                f"{name} {halo}", got["sharded"][name][halo], *dense[name])
            print(f"protein [{name} {halo}] over {n} shards, eager: "
                  f"output within {out_err:.3e} of dense at outputs up "
                  f"to {float(dense[name][0].abs().max()):.3e}, "
                  f"gradients within {grad_err:.3e} of each leaf's "
                  f"scale")
        states = got["sharded"][name]["adam"]
        if not all(torch.equal(states[0][k], st[k]) for st in states
                   for k in states[0]):
            cs.fail(f"{name}: the ranks differ after an Adam step")
    for k, r in enumerate(got["sharded_time"]):
        for key, t in r.items():
            print(f"sharded step rank {k} [{key}] eager: host_ms="
                  f"{t['host_ms']:.4f} busy_ms={t['busy']['busy_ms']:.4f}"
                  f" (without the collectives' kernels "
                  f"{t['busy']['busy_own_ms']:.4f})"
                  f" halo_rows={t['halo_rows']} halo_bytes="
                  f"{t['halo_bytes']} halo_ms={t['halo_ms']:.4f} "
                  f"all_reduce {t['grad_all_reduce_floats']} floats "
                  f"{t['grad_all_reduce_ms']:.4f} ms, broadcast "
                  f"{t['grad_broadcast_floats']} floats "
                  f"{t['grad_broadcast_ms']:.4f} ms")
    hold_captured(got["sharded_graphs"], cases, dense, n, card, cs, torch)
    overlap.report(got["sharded_graphs"], cases, n, card, cs)
    for name, case in cases.items():
        dense_step(name, case, dev, cs, card)


def hold_captured(by_rank, cases, dense, n, card, cs, torch):
    """The captured sharded steps of every rank: rank 0's replayed output
    and gradients against the dense model, every rank's launches at
    replay, the ranks' parameters after the replayed Adam steps, and the
    host and busy ms in turns."""
    for key, r0 in by_rank[0].items():
        name = next(c for c in cases if key.startswith(c))
        out_err, grad_err = cs.hold_sharded(f"captured {key}", r0,
                                            *dense[name])
        a = 6 if name.endswith("_TripletMessage") else 3
        c = 3 if name.endswith("_GATConv") else 0
        for k, r in enumerate(by_rank):
            cs.check_counts(f"captured {key} rank {k}", r[key]["launches"], {
                "triplet_fused_fwd": a, "triplet_fused_bwd": a,
                "segment_softmax_spmm_fwd": c,
                "segment_softmax_spmm_bwd": c})
        states = r0["params"]
        if not all(torch.equal(states[0][k], st[k]) for st in states
                   for k in states[0]):
            cs.fail(f"captured {key}: the ranks differ after the replayed "
                    "Adam steps")
        print(f"protein [{key}] over {n} shards, captured whole (nccl "
              f"collectives inside): output within {out_err:.3e} of dense, "
              f"gradients within {grad_err:.3e} of each leaf's scale; "
              f"launches at replay exact on each rank (A {a}, B {a}, C "
              f"{c}, C's backward {c}); the ranks' {len(states[0])} "
              f"tensors bitwise equal after the replayed Adam steps")
        for k, r in enumerate(by_rank):
            t = r[key]
            be, br = t["busy"], t["busy_replayed"]
            he, hr = (statistics.median(t["turns"][x])
                      for x in ("eager", "replayed"))
            print(f"sharded step rank {k} [{key}]: host ms in turns eager "
                  f"{', '.join(f'{v:.4f}' for v in t['turns']['eager'])}, "
                  f"replayed "
                  f"{', '.join(f'{v:.4f}' for v in t['turns']['replayed'])}"
                  f"; busy ms eager {be['busy_ms']:.4f} (without the "
                  f"collectives' kernels {be['busy_own_ms']:.4f}), replayed "
                  f"{br['busy_ms']:.4f} ({br['busy_own_ms']:.4f}); idle "
                  f"share eager {1 - be['busy_own_ms'] / he:.3f}, replayed "
                  f"{1 - br['busy_own_ms'] / hr:.3f} (of the busy time "
                  f"without the collectives); capture "
                  f"{t['graph_stats']['capture_s']:.3f} s, pool "
                  f"{t['graph_stats']['pool_bytes'] / 2**20:.1f} MiB "
                  f"({card})")


def dense_step(name, case, dev, cs, card):
    """The dense model's Adam step on the case's pair on ``dev``, eagerly
    and replayed (one CUDA graph) in turns: median host ms of 10 each,
    and the profiles' busy ms."""
    import numpy as np
    import torch
    from glam_tpu_torch.cuda_graphs import CapturedCalls
    from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    from glam_tpu_torch.train.optim import make_optimizer
    model = PairArchitecture(ModelConfig(**case["cfg"]), hetero=True)
    model.load_state_dict(case["state"])
    model = model.to(dev).eval()
    pro = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    g1 = pad_graphs([GraphArrays(*case["mols"][0])], 1, 64, 128,
                    num_tasks=1).to(dev)
    g2 = pad_graphs([pro], 1, 8 * -(-(pro.nodes.shape[0] + 1) // 8),
                    8 * -(-pro.senders.shape[0] // 8) + 8,
                    num_tasks=1).to(dev)
    opt = make_optimizer("Adam", model.named_parameters(), 1e-4)

    def step():
        loss = ((model(g1, g2)[:1] - 0.3) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    calls = CapturedCalls(dev)
    calls.warm_up(step)
    graph = calls.capture(step)
    replay = lambda: calls.replay(graph)  # noqa: E731
    for _ in range(3):
        step()
    turns = {"eager": [], "replayed": []}
    for _ in range(2):
        turns["eager"].append(cs.host_step_ms(step, reps=10))
        turns["replayed"].append(cs.host_step_ms(replay, reps=10))
    busy = cs.print_profile(f"dense step [{name}]", step)
    busy_r = cs.print_profile(f"dense step [{name}] replayed", replay)
    print(f"dense step [{name}] on one card: host ms in turns eager "
          f"{', '.join(f'{v:.4f}' for v in turns['eager'])}, replayed "
          f"{', '.join(f'{v:.4f}' for v in turns['replayed'])}; busy_ms "
          f"eager {busy['busy_ms']:.4f}, replayed {busy_r['busy_ms']:.4f} "
          f"({card})")


if __name__ == "__main__":
    main()
