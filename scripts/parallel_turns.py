#!/usr/bin/env python3
"""The parallel steps of two checkouts of the port, timed in turns (old,
new, new, old), each turn its own spawn of the checkout's rank worker
(``tests/torch_port_dp_worker.py``):

    python scripts/parallel_turns.py --old log_parent/ [--ranks 2|4]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory); each
checkout builds its own kernels.  The cases and the flagship's arguments
come from this checkout's ``chip_smoke.py``, so both checkouts run the
same models from the same weights.

``--ranks 2`` (one card, 2 gloo ranks sharing it): the worker's ``time``
task (the data-parallel flagship at full width, batch 64, SGD: each
rank's step eager and replayed in turns, host ms, busy ms), its
``sharded_time`` task (the 1,000-residue protein's sharded Adam step,
GAT and TripletMessage protein towers, a2a and ring: host ms, busy ms)
and its ``sharded_overlap`` task, whose four eager runs a case (the
overlap on, off, off, on) say whether two runs of one setting give the
same gradients bit for bit.

``--ranks 4`` (4 cards, one nccl rank each): the ``time`` task and the
``sharded_graphs`` task at the giant demo's 3,000-residue protein (the
step captured whole with its collectives: host ms eager and replayed in
turns, busy ms).

Prints one line a turn and measurement, the medians of each checkout's
two turns, and a JSON line of everything.  Needs the cards and ``nvcc``;
imports no JAX.
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


def spawn_turn(checkout, work, ranks, torch):
    """The checkout's worker over ``ranks`` ranks on ``work``'s plan;
    rank 0's results."""
    from glam_tpu_torch.parallel import distributed
    worker = Path(checkout).resolve() / "tests" / "torch_port_dp_worker.py"
    procs = distributed.spawn_ranks(
        [sys.executable, str(worker), str(work), "cuda"], ranks, logs=work)
    rc = distributed.wait_ranks(procs, timeout=1500)
    if rc:
        for k in range(ranks):
            print((work / f"rank{k}.out").read_text()[-3000:])
        raise SystemExit(f"{checkout}: a rank exited with {rc}")
    return torch.load(work / "rank0.pt", weights_only=False)


def twice(runs):
    """Of ``sharded_overlap``'s four runs (overlap 1, 0, 0, 1): the
    gradients that differ between the two runs of one setting, their
    count and largest difference."""
    differ, worst = 0, 0.0
    for a, b in ((0, 3), (1, 2)):
        for k, g in runs[a]["grads"].items():
            d = float((g - runs[b]["grads"][k]).abs().max())
            differ += d != 0.0
            worst = max(worst, d)
    return {"tensors": 2 * len(runs[0]["grads"]), "differ": differ,
            "max_abs_diff": worst}


def one_turn(checkout, tmp, turn, ranks, cs, torch):
    """One spawn of the checkout's worker: {measurement: numbers}."""
    work = Path(tmp) / f"turn{turn}"
    work.mkdir()
    if ranks == 2:
        cases = cs.sharded_protein_cases(overlap_ab=True)
        tasks = ["time", "sharded_time", "sharded_overlap"]
    else:
        cases = {k: dict(c, captured_only=True) for k, c in
                 cs.sharded_protein_cases(length=3000, giant=True).items()}
        tasks = ["time", "sharded_graphs"]
    torch.save(cases, work / "sharded.pt")
    (work / "plan.json").write_text(json.dumps({
        "tasks": tasks, "root": str(cs.demo_root(tmp)),
        "configs": {"flagship_demo": cs.DP_STEP_ARGS}, "dump_after": 1400}))
    got = spawn_turn(checkout, work, ranks, torch)
    out = {}
    for k, r in enumerate(got["time"]):
        out[f"dp rank {k}"] = {
            "eager_ms": r["turns"]["eager"],
            "replayed_ms": r["turns"]["replayed"],
            "busy_ms": r["busy"]["busy_ms"],
            "busy_own_ms": r["busy"]["busy_own_ms"],
            "busy_replayed_ms": r["busy_replayed"]["busy_ms"],
            "busy_replayed_own_ms": r["busy_replayed"]["busy_own_ms"],
            "all_reduce_ms": r["all_reduce_ms"]}
    for k, r in enumerate(got.get("sharded_time", [])):
        for key, t in r.items():
            out[f"sharded {key} rank {k}"] = {
                "eager_ms": [t["host_ms"]], "busy_ms": t["busy"]["busy_ms"],
                "busy_own_ms": t["busy"]["busy_own_ms"],
                "enter_local_all_reduce_ms": t["grad_all_reduce_ms"]}
    for k, r in enumerate(got.get("sharded_graphs", [])):
        for key, t in r.items():
            out[f"sharded {key} rank {k}"] = {
                "eager_ms": t["turns"]["eager"],
                "replayed_ms": t["turns"]["replayed"],
                "busy_ms": t["busy"]["busy_ms"],
                "busy_own_ms": t["busy"]["busy_own_ms"],
                "busy_replayed_ms": t["busy_replayed"]["busy_ms"],
                "busy_replayed_own_ms": t["busy_replayed"]["busy_own_ms"]}
    for key, runs in got.get("sharded_overlap", {}).items():
        out[f"backward twice {key}"] = twice(runs)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--old", required=True, help="the other checkout")
    p.add_argument("--ranks", type=int, default=2, choices=(2, 4))
    args = p.parse_args()
    import torch

    import chip_smoke as cs
    if args.ranks == 4 and torch.cuda.device_count() < 4:
        cs.fail("--ranks 4 needs 4 cards")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    turns = [("old", args.old), ("new", str(ROOT)), ("new", str(ROOT)),
             ("old", args.old)]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (which, checkout) in enumerate(turns):
            got = one_turn(checkout, tmp, i, args.ranks, cs, torch)
            results.append((which, got))
            for key, r in got.items():
                print(f"turn {i} {which} [{key}]: {json.dumps(r)}",
                      flush=True)
    for key in results[0][1]:
        if key.startswith("backward twice"):
            continue
        for field in ("eager_ms", "replayed_ms", "busy_ms",
                      "busy_own_ms", "busy_replayed_ms",
                      "busy_replayed_own_ms"):
            if field not in results[0][1][key]:
                continue
            vals = [r[key][field] for _, r in results]
            flat = [statistics.median(v) if isinstance(v, list) else v
                    for v in vals]
            print(f"{key} {field} in turns (old, new, new, old): "
                  f"{', '.join(f'{v:.4f}' for v in flat)}; medians old "
                  f"{statistics.median([flat[0], flat[3]]):.4f}, new "
                  f"{statistics.median([flat[1], flat[2]]):.4f} "
                  f"({args.ranks} ranks; {card})")
    print(json.dumps({"card": card, "ranks": args.ranks,
                      "turns": [{"checkout": w, **r} for w, r in results]}))


if __name__ == "__main__":
    main()
