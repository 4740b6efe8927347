#!/usr/bin/env python3
"""Kernel C (segment softmax + SpMM, forward and backward) of two
checkouts of the port, timed in turns on one CUDA card.

    python scripts/spmm_turns.py --old log_parent/ [--out FILE]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory).  The script
takes the call shapes that ``chip_smoke.py`` checks kernel C at, from
this checkout's data code: ``serve_light`` and ``serve_set2set`` (a
128-molecule demo batch at the serving budgets), ``train_light``,
``train_set2set``, ``train_gat`` and ``train_lapool`` (the batch that
``chip_smoke.py`` draws from each trainer's loader after its training
run: the first of the epoch after the last one trained, batch 32, on
the demo set), the same four calls on the first batch of each other
epoch from 0 to 5 (``..._epoch<e>``: the same row and slot counts, other
molecules), and ``random_h3_c16`` and ``random_h8_c64`` (random CSRs
with empty rows and a 5,000-entry row).  It prints where this
checkout's forward puts the longest row of each trainer's shape
(:func:`longest_row_layout`), then times each checkout's kernels at
those shapes on the same inputs in four processes, old, new, new, old,
and prints one line per state, shape and direction and a JSON line of
all the medians (ms, CUDA events, as ``chip_smoke.device_ms``);
``--out`` also writes the JSON there.  Each turn's process times every
shape at its start ('start'); then, all but the other epochs' batches,
after a
GATConv + GlobalLAPool training run through that checkout's CLI (1
epoch on the demo set, as in ``chip_smoke.py``; 'trained') and after
``chip_smoke.step_timing`` (a profiler trace of a training step;
'profiled'), the state in which ``chip_smoke.py`` times kernel C at the
trainer's shapes; then the trainer's shapes with their inputs moved to
other addresses ('moved1' to 'moved3': a spare allocation of 1-3 x 5
MiB made before them).  Needs one CUDA card and ``nvcc``; imports no
JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ("train_light", "train_set2set", "train_gat", "train_lapool")
BASE = ("serve_light", "serve_set2set") + TRAIN + ("random_h3_c16",
                                                  "random_h8_c64")
# the epoch whose first batch chip_smoke.py checks each call at, and the
# other epochs timed
SMOKE_EPOCH = {"train_light": 2, "train_set2set": 2, "train_gat": 1,
               "train_lapool": 1}
EPOCHS = tuple(f"{n}_epoch{e}" for n in TRAIN for e in range(6)
               if e != SMOKE_EPOCH[n])
SHAPES = BASE + EPOCHS


def make_shapes(path: Path, tmp: Path) -> None:
    """Write each shape's (rowptr, idx, M, H, C) to ``path`` (npz)."""
    import numpy as np
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.data.graph import graph_csr
    from glam_tpu_torch.run import build_parser

    hid = 60
    data = {}

    def put(name, rowptr, idx, M, H, C):
        if name not in SHAPES:            # the smoke's epoch, named so
            return
        data[name] = np.asarray([M, H, C])
        data[f"{name}_rowptr"] = np.asarray(rowptr, np.int32)
        data[f"{name}_idx"] = np.asarray(idx, np.int32)

    serve = cs.demo_batch(cs.read_demo())
    put("serve_light", *serve.padded_csr, serve.num_edges, 1, hid)
    put("serve_set2set", *graph_csr(serve.n_node, serve.num_nodes),
        serve.num_nodes, 1, hid)
    root = tmp / "demo"
    shutil.copytree(cs.DEMO_CSV.parent, root / "raw")

    def batch(flags, epoch=None):
        """The first batch of ``epoch`` (by default the one after the
        last trained) of the loader that a trainer with ``flags`` makes."""
        args = vars(build_parser().parse_args(
            ["--dataset", "demo", "--loss", "bcel", "--dataset_root",
             str(root), "--work_dir", str(tmp)] + flags))
        args, dataset, _ = auto_dataset(args)
        loader = GraphLoader(dataset.train, args["batch_size"],
                             dataset.num_tasks, shuffle=True,
                             seed=args["seed"])
        loader.set_epoch(args["epochs"] if epoch is None else epoch)
        return next(iter(loader))

    for suffix, epoch in [("", None)] + [(f"_epoch{e}", e)
                                         for e in range(6)]:
        b = batch(cs.LIBRARY_ARGS, epoch)
        put(f"train_light{suffix}", *b.padded_csr, b.num_edges, 1, hid)
        put(f"train_set2set{suffix}", *graph_csr(b.n_node, b.num_nodes),
            b.num_nodes, 1, hid)
        b = batch(cs.GAT_ARGS, epoch)
        put(f"train_gat{suffix}", *b.self_loop_csr,
            b.num_edges + b.num_nodes, 1, hid)
        put(f"train_lapool{suffix}", *graph_csr(b.n_node, b.num_nodes),
            b.num_nodes, 1, 2 * hid)
    rng = np.random.RandomState(0)
    for H, C in ((3, 16), (8, 64)):
        rowptr, idx, M = cs.random_segments(rng)
        put(f"random_h{H}_c{C}", rowptr, idx, M, H, C)
    np.savez(path, **data)


def longest_row_layout(path: Path, name: str) -> str:
    """Where the forward kernel of this checkout puts the longest row of
    shape ``name``: its slots, the blocks it crosses (one state each, all
    merged by the block that takes its last ticket) and the rows that the
    chunks of its first block hold (the merge waits for that block, whose
    warps walk one segment per row)."""
    import numpy as np
    from glam_tpu_torch.ops.kernels.segment_softmax_spmm import block_warps
    data = np.load(path)
    rowptr = data[f"{name}_rowptr"].astype(np.int64)
    S, R = int(rowptr[-1]), len(rowptr) - 1
    block = 32 * block_warps(S, 132, R)
    r = int(np.diff(rowptr).argmax())
    beg, end = int(rowptr[r]), int(rowptr[r + 1])
    row_of = np.searchsorted(rowptr, np.arange(S), "right") - 1
    b0 = beg // block * block
    rows = [len(np.unique(row_of[c:min(c + 32, S)]))
            for c in range(b0, min(b0 + block, S), 32)]
    return (f"{name}: longest row {end - beg} slots from slot {beg}, over "
            f"{(end - 1) // block - beg // block + 1} blocks of {block} "
            f"slots (132 SMs); its first block's chunks hold {rows} rows")


def time_checkout(checkout: Path, path: Path) -> dict:
    """Median device ms of ``checkout``'s kernel C at each shape, {shape:
    {'fwd': ms, 'bwd': ms}}, in each state: {'start': ..., 'trained':
    after a training run, 'profiled': after a profiled step, 'moved1'
    ... 'moved3': the trainer's shapes with inputs at other
    addresses}."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    sys.modules.pop("glam_tpu_torch", None)
    from glam_tpu_torch.ops.kernels import segment_softmax_spmm as k
    if not Path(k.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {k.__file__}, not from {checkout}")
    stats_api = len(inspect.signature(
        k.segment_softmax_spmm_bwd).parameters) == 8
    data, dev = np.load(path), torch.device("cuda")

    def time_all(names=SHAPES, spare=0):
        held = torch.empty(spare, dtype=torch.uint8, device=dev)  # noqa: F841
        out = {}
        for name in names:
            M, H, C = (int(v) for v in data[name])
            args = cs.spmm_inputs(np.random.RandomState(SHAPES.index(name)),
                                  data[f"{name}_rowptr"],
                                  data[f"{name}_idx"], M, H, C, dev)
            R = args[2].shape[0] - 1
            g = torch.from_numpy(np.random.RandomState(R).randn(
                R, H * C).astype(np.float32)).to(dev)
            fwd = lambda: k.segment_softmax_spmm_fwd(*args)  # noqa: E731
            if stats_api:                  # takes the forward's results
                stats = fwd()
                bwd = lambda: k.segment_softmax_spmm_bwd(  # noqa: E731
                    *args, *stats, g)
            else:
                bwd = lambda: k.segment_softmax_spmm_bwd(  # noqa: E731
                    *args, g)
            out[name] = {"fwd": cs.device_ms(fwd), "bwd": cs.device_ms(bwd)}
        return out

    out = {"start": time_all()}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = cs.run_cli(tmp, cs.GAT_ARGS, "gat_lapool")[0]
        out["trained"] = time_all(BASE)
        cs.step_timing(trainer, next(iter(trainer.train_loader)).to(dev),
                       "")
    out["profiled"] = time_all(BASE)
    for i in (1, 2, 3):
        out[f"moved{i}"] = time_all(TRAIN, spare=i * (5 << 20))
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", type=Path, help="the other checkout")
    p.add_argument("--out", type=Path, default=None)
    p.add_argument("--time", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--shapes", type=Path, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.time:                                     # one turn, in its process
        print(json.dumps(time_checkout(a.time, a.shapes)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("spmm_turns: no CUDA device")
    if a.old is None or not (a.old / "glam_tpu_torch").is_dir():
        sys.exit("spmm_turns: --old must be a checkout of this repository")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = [("old", a.old), ("new", ROOT), ("new", ROOT), ("old", a.old)]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "shapes.npz"
        make_shapes(path, Path(tmp))
        for name in SHAPES:
            if name.startswith("train_"):
                print(longest_row_layout(path, name))
        for label, checkout in turns:
            proc = subprocess.run(
                [sys.executable, __file__, "--time", str(checkout),
                 "--shapes", str(path)], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"spmm_turns: the {label} turn failed:\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
            results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for state, shapes in results[0].items():
        for name in shapes:
            for w in ("fwd", "bwd"):
                ms = [r[state][name][w] for r in results]
                print(f"{state} {name} {w}: old {ms[0]:.4f} new {ms[1]:.4f} "
                      f"new {ms[2]:.4f} old {ms[3]:.4f} ms; old/new "
                      f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x ({card})")
    line = json.dumps({"card": card, "turns": [t for t, _ in turns],
                       "ms": results})
    print(line)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
