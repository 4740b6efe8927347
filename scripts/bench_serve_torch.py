#!/usr/bin/env python3
"""Serving throughput of the port: ``PairPredictor.predict_scores``
pairs/s on a DTI checkpoint, replayed CUDA graphs against eager forwards
in turns on one card.  The port's counterpart of
``scripts/bench_serve.py``.

    python scripts/bench_serve_torch.py [--ckpt RUN_DIR] [--n 256]
        [--reps 5] [--batch_sizes 16 64 128]

Without ``--ckpt`` it first trains a small dense DTI checkpoint on the
CPU in a subprocess, as the JAX script does (``python -m
glam_tpu_torch.run --dataset bindingdb_c`` on a copy of
``datasets/dti_demo``, a TripletMessage molecule tower and a GATConv
protein tower, so that serving runs kernels A and C; 2 epochs, batch 32,
``--platform cpu``).  Then, at each batch size, a fresh
``PairPredictor(device="cuda")`` serves ``--n`` pairs of the corpus (its
test, validation and training pairs, repeated) end to end: SMILES
featurization, packed batching at the sticky floors, and the forwards.
The first call (one batch eager, the next captured) is timed as cold;
then the request is served ``--reps`` times through the replayed graphs
and ``--reps`` times eagerly (each batch copied to the card field by
field, its forward op by op: ``chip_smoke.eager_rows``), in turns
(replayed, eager, eager, replayed).  Prints a line per batch size with
the kernels' launches a replayed request makes, the card's name and
power limit, and a JSON line of all the numbers.  Needs one CUDA card and
``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARGS = ["--dataset", "bindingdb_c", "--mol_block", "_TripletMessage",
              "--pro_block", "_GATConv", "--epochs", "2", "--batch_size",
              "32", "--platform", "cpu"]


def train_ckpt(tmp: Path) -> Path:
    """A dense DTI run directory trained on the CPU in a subprocess."""
    root = tmp / "dti_demo"
    shutil.copytree(ROOT / "datasets" / "dti_demo" / "raw", root / "raw")
    cmd = [sys.executable, "-m", "glam_tpu_torch.run", "--dataset_root",
           str(root), "--work_dir", str(tmp / "work")] + TRAIN_ARGS
    print("# training a dense DTI checkpoint on the CPU: "
          + " ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True,
                   cwd=ROOT, timeout=1800)
    print(f"# trained in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = sorted(p for p in (tmp / "work" / "log_bindingdb_c").iterdir()
                  if p.is_dir())
    return runs[-1]


def rate(pairs, serve, reps):
    """pairs/s of ``reps`` calls of ``serve(pairs)``."""
    t0 = time.perf_counter()
    for _ in range(reps):
        serve(pairs)
    return len(pairs) * reps / (time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch_sizes", type=int, nargs="+",
                    default=[16, 64, 128])
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_serve_torch: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from glam_tpu_torch.data.pair_datasets import BindingDBDataset
    from glam_tpu_torch.ops.kernels import launch_counts
    from glam_tpu_torch.serve import PairPredictor

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(a.ckpt) if a.ckpt else train_ckpt(Path(tmp))
        ds = BindingDBDataset(str(ROOT / "datasets" / "dti_demo"))
        pool = [(m.smi, p.smi) for m, p in ds.test + ds.val + ds.train]
        pairs = (pool * (a.n // len(pool) + 1))[:a.n]
        card = cs.card_line()
        print(f"# {torch.cuda.get_device_name(0)} ({card}), {len(pairs)} "
              f"pairs, reps={a.reps}")
        rows = []
        for bs in a.batch_sizes:
            pred = PairPredictor.from_checkpoint(
                ckpt, contact_maps=ds.contact_maps, batch_size=bs,
                device="cuda")
            t0 = time.perf_counter()
            pred.predict_scores(pairs)
            cold = len(pairs) / (time.perf_counter() - t0)
            before = launch_counts()
            pred.predict_scores(pairs)
            after = launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            fns = {"replayed": pred.predict_scores,
                   "eager": lambda r: cs.eager_rows(
                       pred, cs.request_items(pred, r)[0])}
            turns = []
            for turn in ("replayed", "eager", "eager", "replayed"):
                turns.append((turn, rate(pairs, fns[turn], a.reps)))
            st = pred.graph_stats
            med = {k: statistics.median(r for t, r in turns if t == k)
                   for k in fns}
            row = {"batch_size": bs, "cold_pairs_per_s": cold,
                   "turns": turns, "replayed_pairs_per_s": med["replayed"],
                   "eager_pairs_per_s": med["eager"],
                   "launches_per_request": launches,
                   "batches_per_request": len(pred.loader(
                       [s for s in pred.samples(pairs) if s is not None])),
                   "captures": st["captures"],
                   "pool_bytes": st["pool_bytes"]}
            rows.append(row)
            print(f"batch_size {bs:4d}: cold {cold:8.1f} pairs/s (one "
                  "batch eager, the next captured); in turns "
                  + ", ".join(f"{t} {r:.1f}" for t, r in turns)
                  + f" pairs/s; {row['batches_per_request']} batches a "
                  f"request, launches a replayed request "
                  f"{json.dumps(launches)}; pool {st['pool_bytes']} bytes "
                  f"({card})", flush=True)
        print(json.dumps({"card": card, "n": len(pairs), "reps": a.reps,
                          "rows": rows}))


if __name__ == "__main__":
    main()
