#!/usr/bin/env python3
"""The node-sharded protein tower over N ranks, one card each (nccl):

    python scripts/sharded_cards.py --ranks 4

Needs N CUDA cards.  In order:
  1. ``python -m glam_tpu_torch.run --pro_shards N`` on dti_demo (one
     epoch, a TripletMessage molecule tower and a GAT protein tower),
     with a2a and with ``--halo ring --pair_batch 4``: the exit code,
     the final line, each rank's launches (A and C 3 a forward, B and
     C's backward 3 a step) and the wall seconds;
  2. the 1,000-residue synthetic protein of ``chip_smoke.py`` at full
     width over N shards (``tests/torch_port_dp_worker.py``, tasks
     ``sharded`` and ``sharded_time``): the output and gradients
     against the dense model on cuda:0 (rtol/atol 1e-4; rtol 2e-4 +
     atol 5e-5 x each leaf's scale), the ranks' parameters after an Adam
     step, and each rank's step, halo and collective times;
  3. the dense model's step on cuda:0 (the same loss and Adam), host and
     busy ms, for the sharded step to be read against.
Prints the cards' names and power limits first.  Exits non-zero on a
failed check.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args()
    import numpy as np
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
    torch.backends.cuda.matmul.allow_tf32 = False
    backend, why = distributed.backend_for("cuda", n,
                                           torch.cuda.device_count())
    print(f"{n} ranks: backend {backend} ({why})")
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (("a2a", []), ("ring", ["--halo", "ring",
                                                    "--pair_batch", "4"])):
            work = Path(tmp) / label
            argv = ["--dataset", "bindingdb_c", "--dataset_root",
                    str(ROOT / "datasets" / "dti_demo"), "--epochs", "1",
                    "--mol_block", "_TripletMessage", "--pro_block",
                    "_GATConv", "--pro_shards", str(n), "--work_dir",
                    str(work)] + extra
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m",
                                   "glam_tpu_torch.run", *argv], cwd=ROOT,
                                  capture_output=True, text=True,
                                  timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode:
                print((proc.stdout + proc.stderr)[-5000:])
                cs.fail(f"run --pro_shards {n} [{label}] exited "
                        f"{proc.returncode}")
            run = next((work / "log_bindingdb_c").iterdir())
            result = json.loads((run / "result.json").read_text())
            f, s = result["forwards"], result["optimizer_steps"]
            for k, counts in enumerate(result["kernel_launches_by_rank"]):
                cs.check_counts(f"{label} rank {k}", counts, {
                    "triplet_fused_fwd": 3 * f, "triplet_fused_bwd": 3 * s,
                    "segment_softmax_spmm_fwd": 3 * f,
                    "segment_softmax_spmm_bwd": 3 * s})
            last = (run / "log.txt").read_text().strip().splitlines()[-1]
            cs.parse_final_line(last)
            print(f"run --pro_shards {n} [{label}]: exit 0, {s} steps, "
                  f"{f} forwards a rank, launches exact on each of {n} "
                  f"ranks, wall_s={wall:.2f}; final line {last}")

        work = Path(tmp) / "protein"
        work.mkdir()
        cases = cs.sharded_protein_cases()
        torch.save(cases, work / "sharded.pt")
        (work / "plan.json").write_text(json.dumps(
            {"tasks": ["sharded", "sharded_time"]}))
        procs = worker.spawn_ranks(work, "cuda", n)
        dense = {name: cs.dense_pair_reference(case, dev)
                 for name, case in cases.items()}
        got = worker.wait_ranks(procs, work, timeout=600)
        for name in cases:
            for halo in ("a2a", "ring"):
                out_err, grad_err = cs.hold_sharded(
                    f"{name} {halo}", got["sharded"][name][halo],
                    *dense[name])
                print(f"protein [{name} {halo}] over {n} shards: output "
                      f"within {out_err:.3e} of dense at outputs up to "
                      f"{float(dense[name][0].abs().max()):.3e}, gradients "
                      f"within {grad_err:.3e} of each leaf's scale")
            states = got["sharded"][name]["adam"]
            if not all(torch.equal(states[0][k], st[k]) for st in states
                       for k in states[0]):
                cs.fail(f"{name}: the ranks differ after an Adam step")
        for k, r in enumerate(got["sharded_time"]):
            for key, t in r.items():
                print(f"sharded step rank {k} [{key}]: host_ms="
                      f"{t['host_ms']:.4f} busy_ms={t['busy']['busy_ms']:.4f}"
                      f" halo_rows={t['halo_rows']} halo_bytes="
                      f"{t['halo_bytes']} halo_ms={t['halo_ms']:.4f} "
                      f"all_reduce {t['grad_all_reduce_floats']} floats "
                      f"{t['grad_all_reduce_ms']:.4f} ms, broadcast "
                      f"{t['grad_broadcast_floats']} floats "
                      f"{t['grad_broadcast_ms']:.4f} ms")
        for name, case in cases.items():
            dense_step(name, case, dev, np, torch, cs)


def dense_step(name, case, dev, np, torch, cs):
    """The dense model's Adam step on the case's pair on ``dev``: median
    host ms of 10 and the profile's busy ms."""
    from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    model = PairArchitecture(ModelConfig(**case["cfg"]), hetero=True)
    model.load_state_dict(case["state"])
    model = model.to(dev).eval()
    pro = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    g1 = pad_graphs([GraphArrays(*case["mols"][0])], 1, 64, 128,
                    num_tasks=1).to(dev)
    g2 = pad_graphs([pro], 1, 8 * -(-(pro.nodes.shape[0] + 1) // 8),
                    8 * -(-pro.senders.shape[0] // 8) + 8,
                    num_tasks=1).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)

    def step():
        loss = ((model(g1, g2)[:1] - 0.3) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    for _ in range(3):
        step()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    busy = cs.print_profile(f"dense step [{name}]", step)
    print(f"dense step [{name}] on one card: host_ms="
          f"{statistics.median(times):.4f} busy_ms={busy['busy_ms']:.4f}")


if __name__ == "__main__":
    main()
