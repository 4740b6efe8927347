#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glam_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``PATH``) and this
checkout; it imports nothing of JAX or of the JAX package.  In order:

  1. the card's name and power limit (``nvidia-smi``);
  2. builds every CUDA kernel of the port from ``glam_tpu_torch/csrc``;
  3. kernel phase: each kernel against its plain torch version on the
     card, at the serving path's shapes (a padded 128-molecule demo batch)
     and on a random batch with empty rows and a high-degree receiver;
     device times (median of CUDA-event timings) beside the bound;
  4. serving phase: the flagship model (TripletMessage H=3 C=60, 3 steps,
     GlobalPool5, e_dim 1024, random weights from seed 0) saved and
     served by ``Predictor(device="cuda")`` for three requests (the whole
     demo corpus, 37 molecules, and one with invalid SMILES); outputs are
     held against ``Predictor(device="cpu")`` on the same checkpoint and
     the kernels' launch counts against the batches served;
  5. a JSON line of the kernels, then the final JSON line.

Exits non-zero, without the final line, if anything fails.
"""
from __future__ import annotations

import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEMO_CSV = ROOT / "datasets" / "demo" / "raw" / "demo.csv"
TOL = 1e-4
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


def demo_csr(demo, n_mol=128):
    """(rowptr, csr_snd, csr_eid, edge_attr) of the serving path's batch:
    the first ``n_mol`` demo molecules that featurize, padded to the
    pinned budgets of ``Predictor(batch_size=n_mol)``."""
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
    b = next(iter(GraphLoader(graphs, n_mol, 1, node_budget=node_budget,
                              edge_budget=edge_budget)))
    return (b.csr_rowptr.numpy(), b.csr_snd.numpy(), b.csr_eid.numpy(),
            b.edges.numpy())


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


def kernel_phase(dev, demo):
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention, triplet_attention_plain)

    H, C = 3, 60
    rng = np.random.RandomState(0)
    cases = {"demo128": demo_csr(demo), "random_hub_empty": random_csr(rng)}
    result = {"max_abs_err": 0.0}
    for name, csr in cases.items():
        args = kernel_inputs(rng, *csr, H, C, dev)
        got = triplet_attention(*args, H, C)
        want = triplet_attention_plain(*args, H, C)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max()) if err.numel() else 0.0
        denom = want.abs().clamp(min=1.0)
        max_rel = float((err / denom).max()) if err.numel() else 0.0
        ok = torch.allclose(got, want, rtol=TOL, atol=TOL)
        empty = torch.from_numpy(np.diff(csr[0]) == 0).to(dev)
        ok = ok and bool((got[empty] == 0).all())
        k_ms = device_ms(lambda: triplet_attention(*args, H, C))
        p_ms = device_ms(lambda: triplet_attention_plain(*args, H, C),
                         reps=20, sleep_cycles=20_000_000)
        bound, bound_by = triplet_bound_ms(args, H, C)
        N, E = args[0].shape[0], args[7].shape[0]
        print(f"kernel triplet_fused_fwd [{name}] N={N} E_real={E} "
              f"H={H} C={C}: max_abs_err={max_abs:.3e} "
              f"max_rel_err={max_rel:.3e} (tol {TOL}) "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={bound:.4f} ({bound_by}) "
              f"share_of_bound={bound / k_ms:.3f}")
        if not ok:
            fail(f"triplet_fused_fwd disagrees with its plain version "
                 f"on {name}: max_abs_err {max_abs}")
        result["max_abs_err"] = max(result["max_abs_err"], max_abs)
        if name == "demo128":
            result.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                          bound_by=bound_by)
    return result


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
    try:
        from torch.profiler import ProfilerActivity, profile
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred.model(moved[0])
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -getattr(
            e, "self_device_time_total", 0.0))
        total = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages())
        print(f"profile one batch forward: device_time_us={total:.1f}")
        for e in rows[:8]:
            print(f"  {e.key[:60]}: device_us="
                  f"{getattr(e, 'self_device_time_total', 0.0):.1f} "
                  f"calls={e.count}")
    except (RuntimeError, AttributeError) as exc:
        print(f"profile: not measured ({exc})")


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
    launches = serving_phase(dev, demo)

    if launches["triplet_fused_fwd"] < 1:
        fail("triplet_fused_fwd never launched on the main path")
    kernels = [{
        "name": "triplet_fused_fwd", "route": "cuda",
        "source": "glam_tpu_torch/csrc/triplet_fused.cu",
        "replaces": "glam_tpu/ops/pallas/triplet_fused.py:236",
        "launches": launches["triplet_fused_fwd"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
