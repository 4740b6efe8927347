#!/usr/bin/env python3
"""How often the smoke's one-process DDI ``captured vs eager`` check
passes, and how far its eager runs lie apart:

    python scripts/ddi_spread.py [--runs 10]

Needs one CUDA card.  Trains the smoke's DDI model (``chip_smoke.py``
``DDI_ARGS``: the CLI at full width, 2 epochs on the bundled
drugbank_caster corpus), then runs ``chip_smoke.captured_vs_eager`` on
it ``--runs`` times, as the smoke runs it once (19 Adam steps from the
trained state, captured and three times eagerly; the captured state
within rtol 1e-4 + 1e-6 x scale, or 1e-4 + twice the eager runs'
spread).  A run that fails the check is counted and its message kept;
the script goes on.  Then ``--deterministic_runs`` more runs under
``torch.use_deterministic_algorithms(True, warn_only=True)``, which
orders every ``index_add_`` of torch's and leaves kernel B's d_xp
atomics as they are: if the spread stays there, kernel B sets it.  The
last line is one JSON object of every run.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def series(cs, trainer, card, runs, label):
    """``runs`` checks; each one's numbers, or its failure's message."""
    out = []
    for i in range(runs):
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                r = dict(cs.captured_vs_eager(f"ddi {label} {i}", trainer,
                                              card), passed=True)
        except SystemExit:                 # the smoke's check failed
            r = {"passed": False, "failure": err.getvalue().strip()}
            print(f"ddi {label} {i}: {r['failure']}", flush=True)
        out.append(r)
    done = [r for r in out if r["passed"]]
    print(f"ddi spread [{label}]: {len(done)} of {runs} runs pass; eager "
          f"spread median "
          f"{statistics.median(r['eager_spread'] for r in done):.3e} (range "
          f"{min(r['eager_spread'] for r in done):.3e}-"
          f"{max(r['eager_spread'] for r in done):.3e}), captured error "
          f"median {statistics.median(r['max_rel_err'] for r in done):.3e} "
          f"(range {min(r['max_rel_err'] for r in done):.3e}-"
          f"{max(r['max_rel_err'] for r in done):.3e}) over the passing "
          f"runs; worst tensors {sorted({r['worst'] for r in done})} "
          f"({card})" if done else f"ddi spread [{label}]: no run passed",
          flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--deterministic_runs", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    import chip_smoke as cs
    from glam_tpu_torch.ops.kernels import build
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    build.build()
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        trainer, _, _, _ = cs.run_cli(tmp, cs.DDI_ARGS, "ddi",
                                      "drugbank_caster")
        got = {"as is": series(cs, trainer, card, args.runs, "as is")}
        if args.deterministic_runs:
            torch.use_deterministic_algorithms(True, warn_only=True)
            got["torch deterministic"] = series(
                cs, trainer, card, args.deterministic_runs,
                "torch deterministic, kernel B as is")
            torch.use_deterministic_algorithms(False)
    keep = ("passed", "max_rel_err", "worst", "eager_spread", "failure")
    print(json.dumps({"card": card, **{
        label: [{k: r.get(k) for k in keep} for r in runs]
        for label, runs in got.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
