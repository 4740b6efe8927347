#!/usr/bin/env python3
"""The flagship's training step of two checkouts of the port, timed in
turns on one CUDA card.

    python scripts/step_turns.py --old log_parent/ [--reps 50]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory).  Each
checkout builds the flagship trainer of ``chip_smoke.py`` (TripletMessage,
_PairNorm, Dropout and RReLU, batch 32, full width, weights from the seed)
through its own ``make_trainer`` on the demo set, moves the first batch
of its loader to the card and times ``train_step`` on it: the host clock
(CUDA events around a step that starts on an idle card, as
``chip_smoke.step_timing``; what a training epoch pays per step) and the
device time (``chip_smoke.device_ms``: the launches queued behind a
spin), medians of ``--reps`` steps after 5 warm-up steps.  The turns run
old, new, new, old, each in its own process; the script prints one line
per turn and a JSON line of all of them.  Needs one CUDA card and
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
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_checkout(checkout: Path, reps: int) -> dict:
    """Host-clock and device ms of ``checkout``'s flagship step."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    sys.modules.pop("glam_tpu_torch", None)
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.ops.kernels import build
    from glam_tpu_torch.run import build_parser
    from glam_tpu_torch.train.trainer import make_trainer
    if not Path(build.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {build.__file__}, not {checkout}")
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "demo"
        shutil.copytree(cs.DEMO_CSV.parent, root / "raw")
        args = vars(build_parser().parse_args(
            ["--dataset", "demo", "--loss", "bcel", "--dataset_root",
             str(root), "--work_dir", tmp] + cs.TRAIN_ARGS))
        args, dataset, kind = auto_dataset(args)
        trainer = make_trainer(args, dataset, kind, work_dir=tmp,
                               device="cuda")
        batch = next(iter(trainer.train_loader)).to("cuda")
        trainer.model.train()
        step = lambda: trainer.train_step(batch)  # noqa: E731
        for _ in range(5):
            step()
        host = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            host.append(start.elapsed_time(end))
        dev_ms = cs.device_ms(step, reps=reps, warmup=3,
                              sleep_cycles=200_000_000)
    return {"step_ms": statistics.median(host), "device_ms": dev_ms}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, help="the other checkout")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.time:                                     # one turn, in its process
        print(json.dumps(time_checkout(a.time, a.reps)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_turns: no CUDA device")
    if a.old is None or not (a.old / "glam_tpu_torch").is_dir():
        sys.exit("step_turns: --old must be a checkout of this repository")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = [("old", a.old), ("new", ROOT), ("new", ROOT), ("old", a.old)]
    results = []
    for label, checkout in turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--time", str(checkout), "--reps",
             str(a.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"step_turns: the {label} turn failed:\n"
                     f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{label}: flagship step_ms={results[-1]['step_ms']:.4f} "
              f"device_ms={results[-1]['device_ms']:.4f} (medians of "
              f"{a.reps}; {card})")
    print(json.dumps({"card": card, "turns": [t for t, _ in turns],
                      "ms": results}))


if __name__ == "__main__":
    main()
