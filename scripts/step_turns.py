#!/usr/bin/env python3
"""The flagship's and the DDI model's training steps of two checkouts of
the port, timed in turns on one CUDA card.

    python scripts/step_turns.py --old log_parent/ [--reps 50]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory).  Each
checkout builds, through its own ``make_auto_trainer``, the flagship
trainer of ``chip_smoke.py`` (TripletMessage, _PairNorm, Dropout and
RReLU, batch 32, full width, weights from the seed) on the demo set and
its DDI trainer (``DDI_ARGS`` on the bundled drugbank_caster corpus),
moves the first batch of each loader to the card and times
``train_step`` on it: the host clock (CUDA events around a step that
starts on an idle card, as ``chip_smoke.step_timing``; what a training
epoch pays per step) and the device time (``chip_smoke.device_ms``: the
launches queued behind a spin), medians of ``--reps`` steps after 5
warm-up steps; then the same step replayed as a CUDA graph
(``StepGraphs``, one step): its host ms and the busy ms of one replay's
profile.  The turns run old, new, new, old, each in its own process; the
script prints one line per turn and model and a JSON line of all of
them.  Needs one CUDA card and ``nvcc``; imports no JAX.
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


MODELS = ("flagship", "ddi")


def host_ms(step, reps, torch):
    """Median host-clock ms of ``step`` from an idle card."""
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
    return statistics.median(host)


def time_checkout(checkout: Path, reps: int) -> dict:
    """Host-clock and device ms of ``checkout``'s flagship and DDI steps,
    eager and replayed."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    sys.modules.pop("glam_tpu_torch", None)
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.ops.kernels import build
    from glam_tpu_torch.run import build_parser
    from glam_tpu_torch.train.pair_trainer import make_auto_trainer
    from glam_tpu_torch.train.step_graph import StepGraphs
    if not Path(build.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {build.__file__}, not {checkout}")
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "demo"
        shutil.copytree(cs.DEMO_CSV.parent, root / "raw")
        data = {"flagship": ["--dataset", "demo", "--loss", "bcel",
                             "--dataset_root", str(root)] + cs.TRAIN_ARGS,
                "ddi": ["--dataset", "drugbank_caster", "--dataset_root",
                        str(ROOT / "datasets" /
                            cs.PAIR_ROOTS["drugbank_caster"])]
                + cs.DDI_ARGS}
        for model in MODELS:
            args = vars(build_parser().parse_args(
                data[model] + ["--work_dir", str(Path(tmp) / model)]))
            args, dataset, kind = auto_dataset(args)
            trainer = make_auto_trainer(args, dataset, kind,
                                        work_dir=str(Path(tmp) / model),
                                        device="cuda")
            batch = trainer._to_device(next(iter(trainer.train_loader)))
            trainer.model.train()
            step = lambda: trainer.train_step(batch)  # noqa: E731
            for _ in range(5):
                step()
            eager = host_ms(step, reps, torch)
            dev_ms = cs.device_ms(step, reps=reps, warmup=3,
                                  sleep_cycles=200_000_000)
            graphs = StepGraphs(trainer._step, trainer._eval_step,
                                trainer.device, trainer.generator)
            host = tuple(p.to("cpu") for p in trainer._as_parts(batch))
            replay = lambda: graphs.train([host], False)  # noqa: E731
            replay()                 # the warm-up step, eager
            replay()                 # the capture, then its replay
            replayed = host_ms(replay, reps, torch)
            prof = cs.print_profile(f"{model} step replayed", replay)
            got[model] = {"step_ms": eager, "device_ms": dev_ms,
                          "replay_ms": replayed,
                          "replay_busy_ms": prof["busy_ms"],
                          "replay_kernels": prof["kernels"]}
    return got


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
        for model, r in results[-1].items():
            print(f"{label}: {model} step_ms={r['step_ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} replay_ms="
                  f"{r['replay_ms']:.4f} replay_busy_ms="
                  f"{r['replay_busy_ms']:.4f} over {r['replay_kernels']} "
                  f"kernels (medians of {a.reps}; {card})")
    print(json.dumps({"card": card, "turns": [t for t, _ in turns],
                      "ms": results}))


if __name__ == "__main__":
    main()
