#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glam_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``PATH``) and this
checkout; it imports nothing of JAX or of the JAX package.  In order:

  1. the card's name and power limit (``nvidia-smi``);
  2. builds every CUDA kernel of the port from ``glam_tpu_torch/csrc``;
  3. kernel phase: each kernel against its plain torch version on the
     card, device times (median of CUDA-event timings) beside the bound:
     kernel A (the triplet-attention forward) at the serving path's
     shapes (a padded 128-molecule demo batch), and kernels A and B (its
     backward) on a random batch with empty rows and a receiver of
     in-degree 500;
  4. serving phase: the flagship model (TripletMessage H=3 C=60, 3 steps,
     GlobalPool5, e_dim 1024, random weights from seed 0) saved and
     served by ``Predictor(device="cuda")`` for three requests (the whole
     demo corpus, 37 molecules, and one with invalid SMILES); outputs are
     held against ``Predictor(device="cpu")`` on the same checkpoint and
     kernel A's launch count against the batches served;
  5. training phase: ``glam_tpu_torch.run.main`` trains the flagship
     model on the demo dataset for 2 epochs on the card (the CLI's
     defaults: _PairNorm, Dropout(0.2), RReLU, Adam, batch 32); the final
     line must parse and be finite, kernel B must launch 3 times per
     optimizer step and kernel A 3 times per forward, the trained
     ``best_save.pt`` must serve on the card as on the CPU; kernels A
     and B against their plain versions, and the differentiable op on
     the card against the CPU, on a batch of the trainer's own loader
     (32 molecules padded to its budgets); one step's gradients must
     agree between the card and the CPU; then the step time,
     molecules/s per epoch and a profile of one step;
  6. a JSON line of the kernels (times at the shapes of the path that
     launches each most, every path's under ``by_path``), the card's
     line, then the final line.

Exits non-zero, without the final line, if anything fails.
"""
from __future__ import annotations

import ast
import csv
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEMO_CSV = ROOT / "datasets" / "demo" / "raw" / "demo.csv"
TOL = 1e-4
# card against CPU, one step's parameter gradients: each tensor within
# GRAD_RTOL relative plus GRAD_ATOL times its largest entry (float32 sums
# in other orders, atomics in kernel B and in index_add_)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
TRAIN_ARGS = ["--dataset", "demo", "--epochs", "2", "--loss", "bcel",
              "--mol_block", "_TripletMessage"]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM, float32 outside tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def device_ms(fn, reps: int = 30, warmup: int = 5,
              sleep_cycles: int = 4_000_000) -> float:
    """Median device time of ``fn()`` in ms.  Before each timed call the
    stream is held by a spin of ``sleep_cycles`` so the call's launches
    queue up behind it and the events time the device work, not the
    host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def read_demo():
    with open(DEMO_CSV, newline="") as f:
        return [row["smiles"] for row in csv.DictReader(f)]


def batch_csr(b):
    """(rowptr, csr_snd, csr_eid, edge_attr) of a padded ``GraphBatch``
    on the host."""
    return (b.csr_rowptr.numpy(), b.csr_snd.numpy(), b.csr_eid.numpy(),
            b.edges.numpy())


def demo_csr(demo, n_mol=128):
    """The CSR of a padded batch of the first ``n_mol`` demo molecules
    that featurize, at the pinned budgets of
    ``Predictor(batch_size=n_mol)``: the serving path's batch."""
    import numpy as np
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.serve import pinned_budgets
    graphs = []
    for smi in demo:
        try:
            x, snd, rcv, e = smiles_to_arrays(smi)
        except ValueError:
            continue
        graphs.append(GraphArrays(x, e, snd, rcv, np.zeros(1, np.float32)))
        if len(graphs) == n_mol:
            break
    node_budget, edge_budget = pinned_budgets(n_mol, 132)
    return batch_csr(next(iter(GraphLoader(
        graphs, n_mol, 1, node_budget=node_budget,
        edge_budget=edge_budget))))


def kernel_inputs(rng, rowptr, csr_snd, csr_eid, edge_attr, H, C, dev):
    """The kernel's arguments on ``dev``: random xp, a_i, a_j, We and a
    block-diagonal wemat drawn from ``rng`` around the given CSR."""
    import numpy as np
    import torch
    N = len(rowptr) - 1
    w_e = rng.randn(H, C).astype(np.float32)
    wemat = np.zeros((H * C, H), np.float32)
    for h in range(H):
        wemat[h * C:(h + 1) * C, h] = w_e[h]
    arrays = [rng.randn(N, H * C).astype(np.float32),
              rng.randn(N, H).astype(np.float32),
              rng.randn(N, H).astype(np.float32), edge_attr,
              (rng.randn(edge_attr.shape[1], H * C) * 0.3).astype(np.float32),
              wemat, rowptr, csr_snd, csr_eid]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def random_csr(rng, n_graphs=640, max_n=40, tail=2048, hub=500, fe=4):
    """Random contiguous graphs, an isolated tail (empty rows) and one
    receiver of in-degree ``hub``."""
    import numpy as np
    from glam_tpu_torch.data.graph import receiver_csr
    off, snd, rcv = 0, [], []
    for gi in range(n_graphs):
        n = rng.randint(4, max_n)
        e = rng.randint(3, 3 * n)
        snd.append(rng.randint(0, n, e) + off)
        rcv.append(rng.randint(0, n, e) + off)
        if gi == 0:
            snd.append(rng.randint(0, n, hub) + off)
            rcv.append(np.full(hub, off + 1))
        off += n
    snd = np.concatenate(snd).astype(np.int32)
    rcv = np.concatenate(rcv).astype(np.int32)
    rowptr, csr_snd, csr_eid = receiver_csr(snd, rcv, off + tail)
    return rowptr, csr_snd, csr_eid, rng.randn(len(snd), fe).astype(
        np.float32)


def triplet_bound_ms(args, H, C):
    """Least time for the work: each needed input byte read once (the
    sender rows of xp and a_j, the rows of a_i with edges, the real edges'
    features and the CSR), the [N, H*C] output written once; against the
    flops of the real edges.  Returns (ms, 'bytes' or 'operations')."""
    import torch
    xp, a_i, a_j, edge_attr, we, wemat, rowptr, csr_snd, csr_eid = args
    N, hc, fe, E = xp.shape[0], H * C, edge_attr.shape[1], csr_snd.shape[0]
    senders = int(torch.unique(csr_snd).numel()) if E else 0
    rows = int((rowptr[1:] > rowptr[:-1]).sum())
    nbytes = 4 * (N * hc                       # out
                  + senders * (hc + H)         # xp, a_j sender rows
                  + rows * H                   # a_i rows with edges
                  + E * (fe + 2) + N + 1       # edge features, CSR
                  + we.numel() + wemat.numel())
    flops = E * (2 * fe * hc + 3 * hc + 2 * fe * H + 8 * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def triplet_bwd_bound_ms(args, H, C):
    """Least time for kernel B's work: the sender rows of xp and a_j, the
    g and a_i rows of receivers with edges, the real edges' features and
    the CSR read once; d_xp [N, H*C], d_eh [E, H*C], d_pre [E, H] and
    d_a_i [N, H] written once; against the flops of the real edges.
    Returns (ms, 'bytes' or 'operations')."""
    import torch
    xp, a_i, a_j, edge_attr, we, wemat, rowptr, csr_snd, csr_eid = args
    N, hc, fe = xp.shape[0], H * C, edge_attr.shape[1]
    E, E_real = edge_attr.shape[0], csr_snd.shape[0]
    senders = int(torch.unique(csr_snd).numel()) if E_real else 0
    rows = int((rowptr[1:] > rowptr[:-1]).sum())
    nbytes = 4 * (senders * (hc + H) + rows * (hc + H)
                  + E_real * (fe + 2) + N + 1
                  + we.numel() + wemat.numel()
                  + N * (hc + H) + E * (hc + H))
    flops = E_real * (2 * fe * hc + 2 * fe * H + 10 * hc + 2 * H * hc
                      + 12 * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _errors(got, want):
    """(max abs error, max error relative to max(|want|, 1))."""
    err = (got - want).abs()
    if not err.numel():
        return 0.0, 0.0
    return (float(err.max()),
            float((err / want.abs().clamp(min=1.0)).max()))


def check_kernel(which, name, csr, rng, dev, H=3, C=60):
    """Kernel A (``which`` 'fwd') or B ('bwd') against its plain version
    on the card, on random inputs drawn from ``rng`` around ``csr``:
    prints the errors and the median device times beside the bound, and
    fails on disagreement.  Returns that line's numbers."""
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention_bwd, triplet_attention_bwd_plain,
        triplet_attention_fwd, triplet_attention_plain)

    args = kernel_inputs(rng, *csr, H, C, dev)
    N, E = args[0].shape[0], args[7].shape[0]
    empty = torch.from_numpy(np.diff(csr[0]) == 0).to(dev)
    if which == "fwd":
        kname = "triplet_fused_fwd"
        run = lambda: triplet_attention_fwd(*args, H, C)  # noqa: E731
        plain = lambda: triplet_attention_plain(*args, H, C)  # noqa: E731
        got, want = [run()], [plain()]
        ok = bool((got[0][empty] == 0).all())
        bound, bound_by = triplet_bound_ms(args, H, C)
    else:
        kname = "triplet_fused_bwd"
        g = torch.from_numpy(rng.randn(N, H * C).astype(np.float32)).to(dev)
        run = lambda: triplet_attention_bwd(*args, g, H, C)  # noqa: E731
        plain = lambda: triplet_attention_bwd_plain(  # noqa: E731
            *args, g, H, C)
        got, want = run(), plain()
        ok = bool((got[3][empty] == 0).all())
        bound, bound_by = triplet_bwd_bound_ms(args, H, C)
    torch.cuda.synchronize()
    errs = [_errors(a, b) for a, b in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    ok = ok and all(torch.allclose(a, b, rtol=TOL, atol=TOL)
                    for a, b in zip(got, want))
    k_ms = device_ms(run)
    p_ms = device_ms(plain, reps=20, sleep_cycles=20_000_000)
    print(f"kernel {kname} [{name}] N={N} E={args[3].shape[0]} "
          f"E_real={E} H={H} C={C}: max_abs_err={max_abs:.3e} "
          f"max_rel_err={max_rel:.3e} (tol {TOL}) "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"bound_ms={bound:.4f} ({bound_by}) "
          f"share_of_bound={bound / k_ms:.3f}")
    if not ok:
        fail(f"{kname} disagrees with its plain version on {name}: "
             f"max_abs_err {max_abs}")
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": bound_by}


def kernel_phase(dev, demo):
    """Kernels A and B on the serving path's batch and on a random batch
    with empty rows and an in-degree-500 hub; the training path's batch
    is checked in :func:`training_phase`, from the trainer's loader."""
    import numpy as np
    rng = np.random.RandomState(0)
    hub = random_csr(rng)
    return {"fwd": {"serve": check_kernel("fwd", "demo128", demo_csr(demo),
                                          rng, dev),
                    "hub": check_kernel("fwd", "random_hub_empty", hub, rng,
                                        dev)},
            "bwd": {"hub": check_kernel("bwd", "random_hub_empty", hub, rng,
                                        dev)}}


def function_on_card_vs_cpu(dev, csr, rng, H=3, C=60):
    """The differentiable op (kernels A and B on the card) against the
    same op on the CPU (the plain versions), on the training batch."""
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.triplet_fused import triplet_attention
    host = kernel_inputs(rng, *csr, H, C, "cpu")
    g = torch.from_numpy(rng.randn(host[0].shape[0], H * C).astype(
        np.float32))
    grads = {}
    for d in ("cpu", dev):
        t = [a.clone().to(d) for a in host]
        for a in t[:6]:
            a.requires_grad_(True)
        triplet_attention(*t, H, C).backward(g.to(d))
        grads[d.type if isinstance(d, torch.device) else d] = [
            a.grad.cpu() for a in t[:6]]
    worst = 0.0
    for name, a, b in zip(("xp", "a_i", "a_j", "edge_attr", "we", "wemat"),
                          grads["cuda"], grads["cpu"]):
        scale = max(float(b.abs().max()), 1.0)
        err = float((a - b).abs().max()) / scale
        worst = max(worst, err)
        if not torch.allclose(a, b, rtol=TOL, atol=1e-5 * scale):
            fail(f"triplet_attention gradient {name}: card and CPU differ "
                 f"by {err:.3e} of its scale")
    print(f"triplet_attention autograd.Function card vs CPU (train_batch): "
          f"max gradient error {worst:.3e} of each tensor's scale "
          f"(tol rtol {TOL}, atol 1e-5 x scale)")


def serving_phase(dev, demo):
    import numpy as np
    import torch
    from glam_tpu_torch.nn.model import Architecture, ModelConfig
    from glam_tpu_torch.ops.kernels.triplet_fused import triplet_attention
    from glam_tpu_torch.serve import Predictor, save_checkpoint

    cfg = ModelConfig(mol_block="_TripletMessage", mol_readout="GlobalPool5",
                      hid_dim_alpha=4, e_dim=1024, message_steps=3)
    model = Architecture(cfg, torch.Generator().manual_seed(0))
    requests = {
        "demo_all": demo,
        "demo_37": demo[600:637],
        "with_invalid": ["CCO", "C1CC", "c1ccccc1", "xyz",
                         "CC(=O)Oc1ccccc1C(=O)O", "C", "N1CC2"],
    }
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, model, {"task": "binary_nan_bce",
                                     "num_tasks": 1, "out_dim": 1})
        pred = Predictor.from_checkpoint(tmp, batch_size=128, device=dev)
        cpu = Predictor.from_checkpoint(tmp, batch_size=128, device="cpu")
    print(f"serving: flagship H=3 C={cfg.hid_dim} steps="
          f"{cfg.message_steps} e_dim={cfg.e_dim} batch_size=128 "
          f"budgets nodes={pred.node_budget} edges={pred.edge_budget}")
    pred.predict_smiles(demo[:16])                 # warm-up, not counted
    torch.cuda.synchronize()

    triplet_attention.launches = 0
    outs, secs = {}, {}
    for name, smis in requests.items():
        t0 = time.perf_counter()
        outs[name] = pred.predict_smiles(smis)
        secs[name] = time.perf_counter() - t0
    launches = {"triplet_fused_fwd": triplet_attention.launches}

    n_batches = 0
    for name, smis in requests.items():
        graphs = pred.featurize(smis)
        valid = np.asarray([g is not None for g in graphs], bool)
        batches = pred.batches([g for g in graphs if g is not None])
        n_batches += len(batches)
        out = outs[name]
        if out.shape != (len(smis), 1):
            fail(f"{name}: output shape {out.shape}")
        if not (np.isfinite(out[valid]).all() and np.isnan(out[~valid]).all()):
            fail(f"{name}: valid rows not finite or invalid rows not NaN")
        want = cpu.predict_smiles(smis)
        err = float(np.nanmax(np.abs(out - want))) if valid.any() else 0.0
        if not np.allclose(out, want, rtol=TOL, atol=TOL, equal_nan=True):
            fail(f"{name}: card and CPU predictions differ by {err}")
        print(f"request {name}: {len(smis)} SMILES ({int(valid.sum())} "
              f"valid) in {len(batches)} batches: latency_s="
              f"{secs[name]:.4f} mol_per_s={len(smis) / secs[name]:.1f} "
              f"max_abs_err_vs_cpu={err:.3e}")
        for i, b in enumerate(batches):
            print(f"  batch {i}: graphs={int(b.graph_mask.sum())} "
                  f"real_nodes={int(b.node_mask.sum())}/{b.num_nodes} "
                  f"real_edges={b.num_real_edges}/{b.num_edges}")
    want = cfg.message_steps * n_batches
    if launches["triplet_fused_fwd"] != want:
        fail(f"triplet_fused_fwd launched {launches['triplet_fused_fwd']} "
             f"times; message_steps x batches = {want}")
    total = sum(len(s) for s in requests.values())
    print(f"serving: {total} SMILES in {sum(secs.values()):.4f} s "
          f"({total / sum(secs.values()):.1f} mol/s); triplet_fused_fwd "
          f"launches={launches['triplet_fused_fwd']} = {cfg.message_steps}"
          f" steps x {n_batches} batches")
    breakdown(pred, demo)
    return launches


def breakdown(pred, demo):
    """Where one request's time goes: featurize, pad, device forward
    (host clock, each stage ending in a synchronize)."""
    import torch
    t0 = time.perf_counter()
    graphs = [g for g in pred.featurize(demo) if g is not None]
    t1 = time.perf_counter()
    batches = pred.batches(graphs)
    t2 = time.perf_counter()
    with torch.inference_mode():
        moved = [b.to(pred.device) for b in batches]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for b in moved:
            pred.model(b)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        fwd_ms = device_ms(lambda: pred.model(moved[0]), reps=10,
                           warmup=2, sleep_cycles=100_000_000)
    print(f"breakdown demo_all: featurize_s={t1 - t0:.4f} pad_s="
          f"{t2 - t1:.4f} to_device_s={t3 - t2:.4f} forward_s="
          f"{t4 - t3:.4f} ({len(batches)} batches); one batch forward "
          f"device_ms={fwd_ms:.4f}")
    with torch.inference_mode():
        print_profile("one batch forward", lambda: pred.model(moved[0]))


def print_profile(label, fn):
    """A ``torch.profiler`` top-8 of one call of ``fn``, by self device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        fail(f"profile of {label}: no device time recorded")
    print(f"profile {label}: device_time_us={total:.1f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:60]}: device_us={e.self_device_time_total:.1f} "
              f"calls={e.count}")


def parse_final_line(line: str):
    """The three dicts of the trainer's last log line, each value a
    finite number; fails otherwise."""
    parts = line.strip().split("|")
    if len(parts) != 3:
        fail(f"final line has {len(parts)} parts: {line!r}")
    dicts = [ast.literal_eval(p) for p in parts]
    for d in dicts:
        if not isinstance(d, dict) or not d or not all(
                isinstance(v, float) and math.isfinite(v)
                for v in d.values()):
            fail(f"final line does not hold finite numbers: {line!r}")
    return dicts


def training_phase(dev, card):
    """Train through the CLI, then check its counts, its checkpoint, one
    step's gradients against the CPU, and time its steps."""
    import numpy as np
    import torch
    from glam_tpu_torch import run
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention, triplet_attention_bwd)
    from glam_tpu_torch.serve import Predictor

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "demo"
        shutil.copytree(DEMO_CSV.parent, root / "raw")
        argv = TRAIN_ARGS + ["--dataset_root", str(root), "--work_dir",
                             str(Path(tmp) / "runs")]
        print(f"training: python -m glam_tpu_torch.run {' '.join(argv)}")
        triplet_attention.launches = 0
        triplet_attention_bwd.launches = 0
        t0 = time.perf_counter()
        trainer = run.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"triplet_fused_fwd": triplet_attention.launches,
                    "triplet_fused_bwd": triplet_attention_bwd.launches}
        run_dir = trainer.log_save_dir
        last = (run_dir / "log.txt").read_text().strip().splitlines()[-1]
        loss_info, test_result, val_result = parse_final_line(last)

        cfg = trainer.model.cfg
        steps = sum(e["steps"] for e in trainer.epoch_stats)
        n_valid, n_test = len(trainer.valid_loader), len(trainer.test_loader)
        forwards = (steps + len(trainer.epoch_stats) * n_valid + n_valid
                    + n_test)
        want = {"triplet_fused_bwd": cfg.message_steps * steps,
                "triplet_fused_fwd": cfg.message_steps * forwards}
        for name, n in want.items():
            if launches[name] != n:
                fail(f"{name} launched {launches[name]} times in training; "
                     f"expected {n}")
        print(f"training: H={trainer.model.mol.conv.conv.heads} "
              f"hid={cfg.hid_dim} steps={cfg.message_steps} "
              f"e_dim={cfg.e_dim} graph_norm={cfg.graph_norm} "
              f"optimizer steps={steps} wall_s={wall:.2f}; launches "
              f"triplet_fused_bwd={launches['triplet_fused_bwd']} = "
              f"{cfg.message_steps} x {steps} steps, triplet_fused_fwd="
              f"{launches['triplet_fused_fwd']} = {cfg.message_steps} x "
              f"{forwards} forwards")
        for i, e in enumerate(trainer.epoch_stats):
            print(f"  epoch {i}: {e['steps']} steps, {e['molecules']} "
                  f"molecules in {e['seconds']:.3f} s = "
                  f"{e['molecules'] / e['seconds']:.1f} molecules/s ({card})")
        print(f"final line: {last}")

        # the trained checkpoint serves on the card as on the CPU
        smis = read_demo()[:64]
        on_card = Predictor.from_checkpoint(run_dir, device=dev)
        on_cpu = Predictor.from_checkpoint(run_dir, device="cpu")
        a, b = on_card.predict_smiles(smis), on_cpu.predict_smiles(smis)
        if not (np.isfinite(a).all() and np.allclose(a, b, rtol=TOL,
                                                     atol=TOL)):
            fail(f"trained best_save.pt: card and CPU predictions differ by "
                 f"{np.abs(a - b).max()}")
        print(f"serving the trained best_save.pt: {len(smis)} SMILES, card "
              f"vs CPU max_abs_err={np.abs(a - b).max():.3e} (tol {TOL})")

        # kernels A and B at the shapes the trainer gives them: a batch of
        # its own loader, padded to the budgets of its largest graphs
        batch = next(iter(trainer.train_loader))
        rng = np.random.RandomState(1)
        csr = batch_csr(batch)
        kern = {w: check_kernel(w, "train_batch", csr, rng, dev)
                for w in ("fwd", "bwd")}
        function_on_card_vs_cpu(dev, csr, rng)
        grads_card_vs_cpu(trainer, cfg, batch, dev)
        step_timing(trainer, batch.to(dev), card)
    return launches, kern


def grads_card_vs_cpu(trainer, cfg, batch, dev):
    """One Adam step from the same weights on the same batch on the card
    and on the CPU, in eval mode (no noise, so both draw none): the
    parameter gradients must agree."""
    import torch
    from glam_tpu_torch.nn.model import Architecture
    from glam_tpu_torch.train.optim import make_optimizer

    state = {k: v.detach().cpu().clone()
             for k, v in trainer.model.state_dict().items()}
    grads, params = {}, {}
    for key, d in (("cpu", "cpu"), ("card", dev)):
        model = Architecture(cfg).to(d)
        model.load_state_dict(state)
        model.eval()
        opt = make_optimizer("Adam", model.named_parameters(), 1e-3)
        b = batch.to(d)
        loss = trainer.loss_fn(model(b), b.y, b.graph_mask)
        opt.zero_grad()
        loss.backward()
        opt.step()
        grads[key] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        params[key] = {n: p.detach().cpu() for n, p in
                       model.named_parameters()}
    worst, worst_name = 0.0, ""
    for name, gc in grads["cpu"].items():
        gg = grads["card"][name]
        scale = float(gc.abs().max())
        err = float((gg - gc).abs().max())
        if not torch.allclose(gg, gc, rtol=GRAD_RTOL,
                              atol=GRAD_ATOL * max(scale, 1e-12)):
            fail(f"gradient of {name}: card and CPU differ by {err:.3e} "
                 f"(scale {scale:.3e})")
        if scale > 0 and err / scale > worst:
            worst, worst_name = err / scale, name
    dp = max(float((params["card"][n] - params["cpu"][n]).abs().max())
             for n in params["cpu"])
    print(f"one Adam step card vs CPU ({len(grads['cpu'])} parameter "
          f"tensors): max gradient error {worst:.3e} of the tensor's "
          f"largest entry ({worst_name}; tol rtol {GRAD_RTOL} + atol "
          f"{GRAD_ATOL} x largest entry); max weight difference after the "
          f"step {dp:.3e}")


def step_timing(trainer, batch, card):
    """Median time of one optimizer step (forward, backward, Adam) on a
    training batch: on the device alone (the launches queued behind a
    spin) and as the host runs it (events around a synchronized step);
    then a profile of one step."""
    import torch
    trainer.model.train()
    step = lambda: trainer.train_step(batch)  # noqa: E731
    dev_ms = device_ms(step, reps=20, warmup=3, sleep_cycles=200_000_000)
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        host.append(start.elapsed_time(end))
    n_mol = int(batch.graph_mask.sum())
    wall_ms = statistics.median(host)
    print(f"training step (batch of {n_mol} molecules, N={batch.num_nodes} "
          f"E={batch.num_edges} E_real={batch.num_real_edges}): "
          f"step_ms={wall_ms:.4f} ({n_mol / wall_ms * 1e3:.1f} molecules/s) "
          f"device_ms={dev_ms:.4f}, medians of 20 CUDA-event timings "
          f"({card})")
    print_profile("one training step", step)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (ROOT / "glam_tpu_torch").is_dir() or not DEMO_CSV.is_file():
        fail("run from a checkout of the repository: glam_tpu_torch/ or "
             "datasets/demo is missing")
    sys.path.insert(0, str(ROOT))
    from glam_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    reports = build.build()
    for name in build.SOURCES:
        print(f"build {name}.cu sha={build.source_hash(name)} "
              f"({'built' if name in reports else 'cached'})")
        for line in reports.get(name, "").splitlines():
            if "ptxas info" in line or "error" in line:
                print(f"  {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s")

    demo = read_demo()
    kern = kernel_phase(dev, demo)
    served = serving_phase(dev, demo)
    trained, kern_train = training_phase(dev, card)
    for which, res in kern_train.items():
        kern[which]["train"] = res

    launches = {"triplet_fused_fwd": {"serve": served["triplet_fused_fwd"],
                                      "train": trained["triplet_fused_fwd"]},
                "triplet_fused_bwd": {"train": trained["triplet_fused_bwd"]}}
    for name, counts in launches.items():
        for path, n in counts.items():
            if n < 1:
                fail(f"{name} never launched on the {path} path")
    # each kernel's times are those at the shapes of the path that
    # launches it most; by_path holds every path's
    meta = {"triplet_fused_fwd": ("fwd", "triplet_fused.cu", 236),
            "triplet_fused_bwd": ("bwd", "triplet_fused_bwd.cu", 296)}
    kernels = []
    for name, (which, src, line) in meta.items():
        counts = launches[name]
        by_path = {path: dict(kern[which][path], launches=n)
                   for path, n in counts.items()}
        main_path = max(counts, key=counts.get)
        k = kern[which][main_path]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"glam_tpu_torch/csrc/{src}",
            "replaces": f"glam_tpu/ops/pallas/triplet_fused.py:{line}",
            "launches": sum(counts.values()),
            "max_abs_err": max(r["max_abs_err"]
                               for r in kern[which].values()),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "by_path": by_path,
        })
    print(json.dumps({"kernels": kernels}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
