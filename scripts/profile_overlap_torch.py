#!/usr/bin/env python3
"""The node-sharded tower's halo/compute overlap measured on the cards:
the counterpart of ``scripts/profile_overlap.py``.

    python scripts/profile_overlap_torch.py [--ranks 4] [--L 1000]

Each message step issues its halo exchange before the terms that do not
read it, and defers the previous step's fusion statistics behind it
(``parallel/sharded_model.py``); ``GLAM_SHARDED_OVERLAP=0`` turns that
off.  Over N ranks, one card each (nccl), for the full-width pair model
(hid 60, 3 steps, e_dim 1024) with a GAT and a TripletMessage protein
tower on ``chip_smoke.py``'s synthetic L-residue protein (or, with
``--giant``, the giant demo's generator's), a2a and ring, the sharded
Adam step captured whole (its collectives inside) with the overlap on
and off (``tests/torch_port_dp_worker.py``, task ``sharded_graphs``),
three measurements:

1. schedule: from a profiler trace of one replay, the NCCL kernels and
   the tower's kernels that start inside their spans (the halo's
   ``AllToAll``/``SendRecv`` ones apart), with the overlap on and off;
2. trace: t_comm (the NCCL kernels' summed duration; they spin while a
   peer is late) and t_comp (the other kernels') a step, beside
   ``bench_scaling.analytic``'s t_comm_us, t_overlap_us and
   overlap_predicted_efficiency for the same L and shard count;
3. A/B: the step's host ms replayed and eager with the overlap on and
   off in turns (1, 0, 0, 1), the no-grad forward's outputs bitwise
   equal either way, eagerly and replayed.

Exits non-zero if the outputs differ, the launches differ, or no tower
kernel runs inside a halo kernel's span with the overlap on.  Imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def report(by_rank, cases, n, card, cs):
    """Print the three measurements of each case the worker's
    ``sharded_graphs`` task ran with ``overlap_ab`` (``by_rank``: every
    rank's result) and hold the A/B; ``cs`` is ``chip_smoke``."""
    import torch
    from glam_tpu_torch.parallel.bench_scaling import analytic
    for key, r0 in by_rank[0].items():
        if "ab" not in r0:
            continue
        name = next(c for c in cases if key.startswith(c))
        triplet = name.endswith("_TripletMessage")
        L = int(cases[name]["graphs"][0][0].shape[0])
        model = analytic(L=L, heads=3 if triplet else 1, shard_counts=(n,))[0]
        halo = "ring" if key.endswith("ring") else "a2a"
        for k, r in enumerate(by_rank):
            ab = r[key]["ab"]
            for what in ("out", "out_replayed"):
                if not torch.equal(ab[f"{what} 1"], ab[f"{what} 0"]):
                    cs.fail(f"overlap [{key}] rank {k}: the {what} with the "
                            f"overlap on and off differ by "
                            f"{float((ab[f'{what} 1'] - ab[f'{what} 0']).abs().max()):.3e}")
            if not torch.equal(ab["out 1"], ab["out_replayed 1"]):
                cs.fail(f"overlap [{key}] rank {k}: the replayed forward "
                        "differs from the eager one")
            if ab["launches 1"] != ab["launches 0"]:
                cs.fail(f"overlap [{key}] rank {k}: launches "
                        f"{ab['launches 1']} on, {ab['launches 0']} off")
            on, off = ab["schedule"]["1"], ab["schedule"]["0"]
            if on["inside_halo"] < 1:
                cs.fail(f"overlap [{key}] rank {k}: with the overlap on, no "
                        f"tower kernel ran inside a halo kernel's span "
                        f"({json.dumps(on)})")
            t = ab["turns"]
            print(f"overlap schedule [{key}] rank {k}: on: "
                  f"{on['inside_halo']} tower kernels ({on['inside_halo_ms']:.4f}"
                  f" ms) start inside the {on['halo_kernels']} halo kernels' "
                  f"spans, {on['inside_nccl']} inside any of the "
                  f"{on['nccl_kernels']} NCCL kernels'; off: "
                  f"{off['inside_halo']} ({off['inside_halo_ms']:.4f} ms) and "
                  f"{off['inside_nccl']}; on's first: "
                  f"{on['inside_halo_names'][:4]} ({card})")
            print(f"overlap trace [{key}] rank {k}: a step's t_comm (NCCL "
                  f"kernels) on {on['nccl_ms']:.4f} ms (halo "
                  f"{on['halo_ms']:.4f}), off {off['nccl_ms']:.4f} "
                  f"({off['halo_ms']:.4f}); t_comp (the other kernels) on "
                  f"{on['busy_own_ms']:.4f}, off {off['busy_own_ms']:.4f}; "
                  f"analytic (L={L}, {n} shards, heads "
                  f"{3 if triplet else 1}, an H100's rates): t_comp "
                  f"{model['t_compute_us'] / 1e3:.4f} ms, t_comm "
                  f"{(model['t_comm_us'] if halo == 'a2a' else model['ring_t_comm_us']) / 1e3:.4f}"
                  f" ms, t_overlap {model['t_overlap_us'] / 1e3:.4f} ms, "
                  f"predicted efficiency without overlap "
                  f"{model['predicted_efficiency' if halo == 'a2a' else 'ring_predicted_efficiency']:.4f}"
                  f", with it "
                  f"{model['overlap_predicted_efficiency' if halo == 'a2a' else 'ring_overlap_predicted_efficiency']:.4f}"
                  f"; measured t_comp / replayed host ms on "
                  f"{on['busy_own_ms'] / statistics.median(t['replayed 1']):.4f},"
                  f" off {off['busy_own_ms'] / statistics.median(t['replayed 0']):.4f}"
                  f" ({card})")
            print(f"overlap A/B [{key}] rank {k}: host ms in turns (1, 0, 0, "
                  f"1) replayed on "
                  f"{', '.join(f'{v:.4f}' for v in t['replayed 1'])}, off "
                  f"{', '.join(f'{v:.4f}' for v in t['replayed 0'])}; eager "
                  f"on {', '.join(f'{v:.4f}' for v in t['eager 1'])}, off "
                  f"{', '.join(f'{v:.4f}' for v in t['eager 0'])}; busy ms "
                  f"replayed on {on['busy_ms']:.4f} ({on['busy_own_ms']:.4f} "
                  f"without NCCL's), off {off['busy_ms']:.4f} "
                  f"({off['busy_own_ms']:.4f}); outputs bitwise equal on and "
                  f"off, eager and replayed; launches equal "
                  f"{json.dumps(ab['launches 1'])} ({card})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--L", type=int, default=1000)
    p.add_argument("--giant", action="store_true",
                   help="the giant demo's generator's protein")
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    import torch_port_dp_worker as worker
    from glam_tpu_torch.ops.kernels import build
    n = args.ranks
    if torch.cuda.device_count() < n:
        cs.fail(f"{n} ranks need {n} cards, have {torch.cuda.device_count()}")
    card = cs.card_line()
    print(card)
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        cases = cs.sharded_protein_cases(length=args.L, giant=args.giant,
                                         overlap_ab=True)
        torch.save(cases, work / "sharded.pt")
        (work / "plan.json").write_text(json.dumps(
            {"tasks": ["sharded_graphs"], "dump_after": 840}))
        got = worker.wait_ranks(worker.spawn_ranks(work, "cuda", n), work,
                                timeout=900)
        for k in range(n):
            for line in (work / f"rank{k}.out").read_text().splitlines():
                if line.startswith("overlap "):
                    print(f"  [rank {k}] {line}")
        report(got["sharded_graphs"], cases, n, card, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
