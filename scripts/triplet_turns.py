#!/usr/bin/env python3
"""Kernels A and B (the triplet-attention forward and backward) of two
checkouts of the port, timed in turns on one CUDA card.

    python scripts/triplet_turns.py --old log_parent/ [--out FILE]

``--old`` is another checkout of this repository (e.g. a parent commit
unpacked with ``git archive`` into a gitignored directory).  The shapes
are those ``chip_smoke.py`` checks kernels A and B at, from this
checkout's data code, all at the flagship's H = 3, C = 60: ``demo128``
(a 128-molecule demo batch at the serving budgets: 16,904 rows, most of
them padding), ``train_batch`` (the batch ``chip_smoke.py`` draws from
the flagship trainer's loader: the first of the epoch after the 2
trained, batch 32, on the demo set) and ``random_hub_empty`` (random
graphs, 2,048 empty rows and a receiver of in-degree 500); and
``random_h8_c64``, the same CSR at 8 heads of 64 channels.  Each
checkout's kernels run on the same inputs in four processes, old, new,
new, old, each timing every shape at its start; the script prints one
line per shape and direction and a JSON line of all the medians (ms,
CUDA events, as ``chip_smoke.device_ms``), with this checkout's d_xp
fill (the backward's one fill) timed alone beside them; ``--out`` also
writes the JSON there.  A checkout's backward is called as its wrapper
takes it: from the forward's output and statistics, or (before they
existed) from the inputs alone; with the sender CSR made once where it
takes one, as the model calls it.  Where the backward sums d_xp with
the CSR sum, ``bwd_kernel`` times it with that sum left out (kernel B
alone: the wrapper's allocation and its one launch).  Needs one CUDA
card and ``nvcc``; imports no JAX.
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
SHAPES = {"demo128": (3, 60), "train_batch": (3, 60),
          "random_hub_empty": (3, 60), "random_h8_c64": (8, 64)}


def make_shapes(path: Path, tmp: Path) -> None:
    """Write each shape's CSR (rowptr, snd, eid, edge_attr) to ``path``."""
    import numpy as np
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.run import build_parser

    root = tmp / "demo"
    shutil.copytree(cs.DEMO_CSV.parent, root / "raw")
    args = vars(build_parser().parse_args(
        ["--dataset", "demo", "--loss", "bcel", "--dataset_root", str(root),
         "--work_dir", str(tmp)] + cs.TRAIN_ARGS))
    args, dataset, _ = auto_dataset(args)
    loader = GraphLoader(dataset.train, args["batch_size"],
                         dataset.num_tasks, shuffle=True, seed=args["seed"])
    loader.set_epoch(args["epochs"])
    hub = cs.random_csr(np.random.RandomState(0))
    csrs = {"demo128": cs.demo_csr(cs.read_demo()),
            "train_batch": cs.batch_csr(next(iter(loader))),
            "random_hub_empty": hub, "random_h8_c64": hub}
    np.savez(path, **{f"{name}_{i}": a for name, csr in csrs.items()
                      for i, a in enumerate(csr)})


def time_checkout(checkout: Path, path: Path) -> dict:
    """Median device ms of ``checkout``'s kernels A and B at each shape:
    {shape: {'fwd': ms, 'bwd': ms}}, and for a backward with one fill,
    'fill': that fill's ms alone."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(checkout))
    sys.modules.pop("glam_tpu_torch", None)
    from glam_tpu_torch.ops.kernels import triplet_fused as k
    if not Path(k.__file__).resolve().is_relative_to(checkout.resolve()):
        raise RuntimeError(f"imported {k.__file__}, not from {checkout}")
    params = inspect.signature(k.triplet_attention_bwd).parameters
    stats_api = "row_max" in params
    data, dev = np.load(path), torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for i, (name, (H, C)) in enumerate(SHAPES.items()):
        csr = [data[f"{name}_{j}"] for j in range(4)]
        rng = np.random.RandomState(i)
        args = cs.kernel_inputs(rng, *csr, H, C, dev)
        N = args[0].shape[0]
        g = torch.from_numpy(rng.randn(N, H * C).astype(np.float32)).to(dev)
        fwd = lambda: k.triplet_attention_fwd(*args, H, C)  # noqa: E731
        if stats_api:
            stats = fwd()
            # the sender CSR made once, as a batch carries it, and the
            # sums ending at the real edges where the checkout has them
            extra = {}
            if "snd_rowptr" in params:
                kw = ({"csr_rowptr": args[6]} if "csr_rowptr" in
                      inspect.signature(k.sender_csr_of).parameters else {})
                snd = k.sender_csr_of(args[7], args[8], N, **kw)
                extra = dict(snd_rowptr=snd[0], snd_eid=snd[1])
            bwd = lambda: k.triplet_attention_bwd(  # noqa: E731
                *args, *stats, g, H, C, **extra)
        else:
            bwd = lambda: k.triplet_attention_bwd(  # noqa: E731
                *args, g, H, C)
        out[name] = {"fwd": cs.device_ms(fwd), "bwd": cs.device_ms(bwd)}
        if hasattr(k, "segment_sum_csr"):
            # kernel B alone: its wrapper's d_xp sum made the identity
            summed = k.segment_sum_csr
            k.segment_sum_csr = lambda x, *rest: x
            try:
                out[name]["bwd_kernel"] = cs.device_ms(bwd)
            finally:
                k.segment_sum_csr = summed
        if stats_api:
            out[name]["fill"] = cs.device_ms(lambda: torch.zeros(
                (N, H * C), device=dev))
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
        sys.exit("triplet_turns: no CUDA device")
    if a.old is None or not (a.old / "glam_tpu_torch").is_dir():
        sys.exit("triplet_turns: --old must be a checkout of this "
                 "repository")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = [("old", a.old), ("new", ROOT), ("new", ROOT), ("old", a.old)]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "shapes.npz"
        make_shapes(path, Path(tmp))
        for label, checkout in turns:
            proc = subprocess.run(
                [sys.executable, __file__, "--time", str(checkout),
                 "--shapes", str(path)], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"triplet_turns: the {label} turn failed:\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
            results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name in SHAPES:
        for w in ("fwd", "bwd", "bwd_kernel"):
            if not all(w in r[name] for r in results):
                continue
            ms = [r[name][w] for r in results]
            print(f"{name} {w}: old {ms[0]:.4f} new {ms[1]:.4f} new "
                  f"{ms[2]:.4f} old {ms[3]:.4f} ms; old/new "
                  f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x ({card})")
        fills = [r[name]["fill"] for r in results if "fill" in r[name]]
        if fills:
            print(f"{name} d_xp fill alone: "
                  f"{' '.join(f'{f:.4f}' for f in fills)} ms ({card})")
    line = json.dumps({"card": card, "turns": [t for t, _ in turns],
                       "ms": results})
    print(line)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
