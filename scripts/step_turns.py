#!/usr/bin/env python3
"""The flagship's and the DDI model's training steps of two checkouts of
the port, timed in turns on one CUDA card.

    python scripts/step_turns.py --old log_parent/ [--reps 50]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory).  Each
checkout builds, through its own ``make_auto_trainer``, the flagship
trainer of ``chip_smoke.py`` (TripletMessage, _PairNorm, Dropout and
RReLU, batch 32, full width, weights from the seed) on the demo set, its
DDI trainer (``DDI_ARGS`` on the bundled drugbank_caster corpus) and the
trainers of the AutoML search's four configurations at its seed
(``chip_smoke.automl_configs``, as its trials run them, on
physprop_perturb: ``automl_<id>``), moves the first batch of each loader
to the card and times
``train_step`` on it: the host clock (CUDA events around a step that
starts on an idle card, as ``chip_smoke.step_timing``; what a training
epoch pays per step) and the device time (``chip_smoke.device_ms``: the
launches queued behind a spin), medians of ``--reps`` steps after 5
warm-up steps; then the same step replayed as a CUDA graph
(``StepGraphs``, one step): its host ms and the busy ms of one replay's
profile.  The turns run old, new, new, old, each in its own process; the
script prints one line per turn and model and a JSON line of all of
them.  Needs one CUDA card and ``nvcc``; imports no JAX.

Each turn also splits the step's CSR sums by call: one eager step records
every launch of the checkout's ``segment_sum_csr`` (the batch CSR it runs
on: graph, sender, receiver or one built on the device; its width C and
dtype; its longest row, cut at its limit; whether it has one), and a
profiled replay gives each of those kernels' µs, in launch order: the
``csr sums`` lines; and, where the checkout counts them, the segments
one replay merged at the CSR sum's global level (counted on the
device).  ``--time DIR`` times one checkout alone and prints its JSON
line.
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


# a batch CSR's row pointers -> the name the breakdown gives it
CSR_NAMES = {"graph_rowptr": "graph", "snd_rowptr": "sender",
             "pad_rowptr": "receiver", "csr_rowptr": "receiver_real",
             "loop_rowptr": "self_loop"}


def record_csr_calls(module, step, parts):
    """Run ``step`` once, eagerly, recording every launch of ``module``'s
    CSR-sum kernel (its ``_launch``): the batch CSR it sums over, C,
    dtype, longest row (cut at the limit) and whether it has a limit."""
    import torch
    names = {getattr(b, f).data_ptr(): f"{CSR_NAMES[f]}" + (
        f"[{i}]" if len(parts) > 1 else "")
        for i, b in enumerate(parts) for f in CSR_NAMES}
    calls = []
    launch = module._launch

    def recorded(x, rowptr, perm=None, *rest):
        limit = rest[0] if rest else None
        lens = rowptr.clamp(max=limit) if limit is not None else rowptr
        lens = (lens[1:] - lens[:-1]).max() if rowptr.numel() > 1 else 0
        calls.append({"csr": names.get(rowptr.data_ptr(), "built"),
                      "C": int(torch.tensor(x.shape[1:]).prod()),
                      "dtype": str(x.dtype)[6:], "longest": int(lens),
                      "limit": limit is not None})
        return launch(x, rowptr, perm, *rest)

    module._launch = recorded
    try:
        step()
        torch.cuda.synchronize()
    finally:
        module._launch = launch
    return calls


def csr_kernel_us(fn):
    """The µs of each CSR-sum kernel in one profiled call of ``fn``, in
    the order they ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "sum_kernel" in e.name),
                key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in ev]


def time_checkout(checkout: Path, reps: int) -> dict:
    """Host-clock and device ms of ``checkout``'s flagship and DDI steps,
    eager and replayed."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    sys.modules.pop("glam_tpu_torch", None)
    from glam_tpu_torch.automl.search_space import config2cmd
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.ops.kernels import build
    from glam_tpu_torch.ops.kernels import segment_sum_csr as csr_module
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
        physprop = Path(tmp) / "physprop"
        shutil.copytree(cs.PHYSPROP_CSV.parent, physprop / "raw")
        for cfg in cs.automl_configs():
            data[f"automl_{cfg['note']}"] = config2cmd(cfg)[2:] + [
                "--dataset_root", str(physprop)]
        for model in data:
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
            calls = record_csr_calls(csr_module, step, batch)
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
            us = csr_kernel_us(replay)
            merges = None
            if hasattr(csr_module, "ticket_merges"):
                csr_module.ticket_merges(trainer.device)
                replay()
                merges = csr_module.ticket_merges(trainer.device)
            if len(us) == len(calls):
                for c, t in zip(calls, us):
                    c["us"] = t
            got[model] = {"step_ms": eager, "device_ms": dev_ms,
                          "replay_ms": replayed,
                          "replay_busy_ms": prof["busy_ms"],
                          "replay_kernels": prof["kernels"],
                          "replay_ticket_merges": merges,
                          "csr_us": us, "csr_calls": calls}
    return got


def print_csr_calls(label, model, r, card):
    """The ``csr sums`` lines of one turn's model: the replay's µs each,
    then each call's CSR, width, dtype, longest row and µs."""
    us = r["csr_us"]
    merges = r.get("replay_ticket_merges")
    print(f"{label}: {model} csr sums: {len(us)} kernels in the replay, "
          f"{sum(us):.1f} us, us each: "
          + ", ".join(f"{t:.1f}" for t in us)
          + ("" if merges is None else
             f"; segments merged at the global level in a replay: "
             f"{merges}") + f" ({card})")
    for i, c in enumerate(r["csr_calls"]):
        at = f"{c['us']:.1f} us" if "us" in c else "not matched"
        print(f"  {i:2d}: {c['csr']} C={c['C']} {c['dtype']} longest="
              f"{c['longest']} limit={c['limit']}: {at}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, help="the other checkout")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--time", type=Path,
                   help="time this checkout alone (one turn)")
    a = p.parse_args()
    if a.time:                                     # one turn, in its process
        got = time_checkout(a.time, a.reps)
        for model, r in got.items():
            print_csr_calls(str(a.time), model, r, "")
        print(json.dumps(got))
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
            print_csr_calls(label, model, r, card)
    print(json.dumps({"card": card, "turns": [t for t, _ in turns],
                      "ms": results}))


if __name__ == "__main__":
    main()
