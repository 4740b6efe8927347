#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glam_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``PATH``) and this
checkout; it imports nothing of JAX or of the JAX package.  In order:

  1. the card's name and power limit (``nvidia-smi``);
  2. builds every CUDA kernel of the port from ``glam_tpu_torch/csrc``
     (one ``nvcc`` per source, all started together) and, beside them,
     the C++ SMILES featurizer (``g++``), printing its build seconds;
     then ``native``: the C++ featurizer against the Python one, byte
     for byte, on the demo corpus and on ``datasets/physprop`` (12,607
     SMILES, whose 2 hypervalent iodine SMILES both reject), with each
     one's seconds and molecules/s;
  3. kernel phase: each kernel against its plain torch version on the
     card, device times (median of CUDA-event timings) beside the bound:
     kernel A (the triplet-attention forward, with its row statistics)
     at the serving path's shapes (a padded 128-molecule demo batch),
     kernels A and B (its backward, fed A's output and statistics) on a
     random batch with empty rows and a receiver of in-degree 500, at
     H*C = 180 and 512; kernel C (segment softmax + SpMM, forward and
     backward, held against its plain version in float64) at the
     serving path's TripletMessageLight and Set2Set calls (the last
     node's padded edges and the padding graph are rows of ~44,000 and
     ~13,800 entries) and on random CSRs with empty rows and a
     5,000-entry row at (H, C) = (3, 16) and H*C = 512; each call must
     give bitwise the same results twice (B: d_eh, d_pre and d_a_i; its
     d_xp is summed with atomics) and run the device kernels its design
     states (A one; B two, the d_xp fill and the kernel; C one each way,
     the backward with unlisted entries also zero-filling): the calls of
     every kernel check of the run are traced at its end, in one fresh
     process, and the kernel lines printed then; then ``stress``:
     kernels A and B 40 rounds over the card tests' CSRs with rows of
     40-3,000 edges, on one stream and on two at once, every call
     bitwise equal to the first, the autograd Function's gradients
     against a float64 CPU reference, every ticket buffer zero after
     every call (``--stress N`` runs it alone);
  4. serving phase: the flagship model (TripletMessage H=3 C=60, 3 steps,
     GlobalPool5, e_dim 1024, random weights from seed 0) saved and
     served by ``Predictor(device="cuda")`` for three requests (the whole
     demo corpus, 37 molecules, and one with invalid SMILES); outputs are
     held against ``Predictor(device="cpu")`` on the same checkpoint and
     kernel A's launch count against the batches served; the demo
     corpus's featurize seconds (now native) beside the Python
     featurizer's earlier ones (PYTHON_FEATURIZE).  Every predictor on
     the card serves through CUDA graphs (``cuda_graphs.ForwardGraphs``:
     a signature's first batch eager, its second captured, the rest
     replayed); each serving phase prints ``served_graphs=true`` with
     its captures, replays, capture seconds and pool bytes, holds the
     served rows bitwise equal to the same predictor's eager forward on
     the card (``eager_rows``), and times in turns, within this call,
     each request and one served batch eagerly (copied to the card field
     by field, forward op by op) and replayed (host ms, busy ms, idle
     share);
     ``jax_checkpoint``: the two JAX-written checkpoints of
     ``tests/data/jax_ckpt`` (the flagship; TripletMessageLight + Set2Set
     with BatchNorm) served through ``Predictor.from_checkpoint(...,
     which="best_save.ckpt")``, then ``EnsemblePredictor.from_runs`` over
     both, scores within rtol 1e-4 + atol 1e-4 of the JAX package's own
     (``expected.npz``), NaN rows at the invalid SMILES, launches exact
     (A 3 a batch; C 6 a batch); ``viz``: ``Visualizer.weights`` on 8
     SMILES over them (``hidden_node``, ``triplet_attention``,
     ``set2set_attention``) within 1e-4 of the JAX Visualizer's, one
     forward a molecule;
  5. training phases, each through ``glam_tpu_torch.run.main`` on the
     demo dataset at full width (the CLI's defaults otherwise: Adam,
     batch 32, Dropout(0.2) and RReLU, ``--scan_steps 8``), each final
     line parsed and finite, each kernel's launches counted around each
     run alone, the replays of the run's CUDA graphs included (every
     one-process run on the card must replay them: ``result.json``'s
     ``step_graphs``; each run prints its captures, their seconds, the
     eager warm-up groups' seconds, replays and pool bytes); for the
     flagship, the library, DDI and DTI, ``captured vs eager``: 2 x 8 + 3
     steps from one state through the graphs (an eager group of 8, one
     8-step replay, a ReduceLROnPlateau cut of the learning rate, three
     one-step replays) and eagerly three times, the parameters, BatchNorm
     statistics and optimizer state held at rtol 1e-4 + 1e-6 x scale or,
     as a share of each tensor's largest entry, within 1e-4 beyond twice
     the spread of three eager runs, the launches equal (the
     flagship also with SGD, with its RReLU and Dropout noise, whose
     losses must show the replays drawing the eager steps' masks, and
     Ranger over 13 steps at S = 4); and ``step graphs [...]``: the step
     eager, as a one-step replay and as an 8-step replay, timed in turns
     (host ms, busy ms, kernels, idle share, samples/s), then whole
     epochs in turns (eager, captured with its captures, captured twice,
     eager):
     - the flagship (TripletMessage, _PairNorm), 2 epochs: kernel B 3
       times per optimizer step, kernel A 3 times per forward; the
       trained ``best_save.pt`` serves on the card as on the CPU;
       kernels A and B and their Function against the CPU on a batch of
       the trainer's own loader (its CSR padded to the edge budget: A's
       and B's results bitwise those over its real slots, B's d_xp
       within 1e-6); one step's gradients card vs CPU; step
       time and a profile;
     - TripletMessageLight + Set2Set with _BatchNorm (graph, flat) and
       _LayerNorm (end), 2 epochs: kernel C 6 times per forward and per
       step, A and B never; one training-mode step's gradients card vs
       CPU; kernel C at the trainer's batch (the conv's and Set2Set's
       calls); step time and a profile; the trained checkpoint, running
       statistics included, serves the whole corpus in batches of 128 on
       the card as on the CPU, kernel C 6 times per batch;
     - GATConv + GlobalLAPool with _LayerNorm and _GraphSizeNorm, 1
       epoch: kernel C 4 times per forward and per step; gradients card
       vs CPU; kernel C at the trainer's batch (GAT's edges and
       self-loops, GlobalLAPool's graphs at width 120);
     - the flagship (2 epochs) and TripletMessageLight + Set2Set (1
       epoch) at ``--dtype bfloat16``: final lines finite, masters and
       checkpoints float32, launches exact, one step's gradients on the
       card as close to the float32 ones as the CPU's (BF16_GRAD_TOL),
       the step's times
       beside the float32 run's;
     - the CLI's default (_NNConv, GlobalPool5, _PairNorm), 1 epoch: no
       kernel; then one step of a _GCNConv model's gradients card vs CPU;
  6. the pair families, each through ``glam_tpu_torch.run.main`` on its
     bundled corpus at full width (hid 60, 3 steps, e_dim 1024,
     GlobalPool5 in both towers), launches counted around each run:
     - ``ddi``: drugbank_caster (ddi_demo), TripletMessage towers, 2
       epochs: kernel A 6 times per forward (3 per tower), B 6 per
       step; the trained ``best_save.pt`` served by ``PairPredictor`` on
       the card as on the CPU on the test pairs; kernels A and B at each
       tower's batch of the trainer's loader; one training-mode step's
       gradients card vs CPU; step time and a profile;
     - ``dti``: bindingdb_c (dti_demo), a TripletMessage molecule tower
       and a GATConv protein tower, 1 epoch: A 3 per forward, B 3 per
       step, kernel C 3 per forward and 3 per step; kernel C at the
       protein tower's batch (edges and self-loops), A and B at the
       molecule tower's; the checkpoint served on the card as on the CPU;
       gradients card vs CPU; step time and a profile;
     - ``dti_serving``: a full-width DTI model (GATConv protein tower,
       pro_max_nodes 1024) with random weights from seed 0, saved and
       served by ``PairPredictor(device="cuda", batch_size=16)``: 64 demo
       SMILES against one 1,000-residue protein made from a seed (~12
       contacts per residue), and a request with an invalid SMILES and
       a protein without a contact map (NaN rows); card vs CPU; kernel
       C 3 times per batch, and at the served batch's self-loop CSR
       (16 proteins, ~16,000 rows); pairs/s and a batch's device ms; a
       first request of the 32 smallest molecules captures a graph, and
       the second request's floor growth must free it (the memory held
       within one pool of where it was);
     - ``screening``: ALDH1 (scr_demo) with the CLI's defaults
       (GCNConv protein tower, loss wce), 1 epoch: A 3 per forward, B 3
       per step, C never; the final line has bedroc;
     each through CUDA graphs, as in 5, ``captured vs eager`` and the
     step's timing in turns for DDI and DTI;
  6b. the parallel layer, 2 gloo ranks sharing the card (NCCL refuses
     two ranks on one GPU; every figure is of ranks time-sliced on one
     card, no scaling number): ``dp``, the flagship through
     ``python -m glam_tpu_torch.run --n_devices 2`` (batch 64, 32 a
     rank, 1 epoch; A 3 per forward and B 3 per step on each rank,
     exact; the final line once), then 2 ranks of
     ``tests/torch_port_dp_worker.py`` (the card test's) for a one-step
     parity (noise off, SGD; and the merged evaluation) against one
     process on the card, each rank's step host and busy ms and the
     gradient all-reduce's ms, and ``halo``: the v1 (all_gather) and v2
     (all_to_all) halo steps on the 1,000-residue synthetic protein's
     graph over 2 shards at C = 60, kernel C 1 launch a step a rank,
     against the plain ``reference_halo_step`` on the card, with the
     bytes a rank receives and each step's ms; ``dp_library`` (Light +
     Set2Set with BatchNorm: C 6 each way) and ``dp_pair`` (DDI: A 6, B
     6); the kernels at a rank's batch and at the halo's CSR; then the
     node-sharded protein tower on 2 gloo ranks of the card:
     ``sharded_dti`` and ``sharded_ring`` (``python -m
     glam_tpu_torch.run --dataset bindingdb_c ... --pro_shards 2``, the
     second with ``--halo ring --pair_batch 4``, 1 epoch, the
     TripletMessage molecule tower and the GAT protein tower: launches
     of A, B, C and C's backward exact on each rank, the final line
     once, the checkpoint served by ``PairPredictor`` on the card as on
     the CPU) and ``sharded_protein`` (the 1,000-residue synthetic
     protein at full width over 2 shards with a demo molecule, GAT and
     TripletMessage towers, a2a and ring: the sharded pair forward and
     gradients against the dense model on the card, the ranks equal
     after one Adam step, each rank's step host and busy ms, the halo
     exchange's bytes and ms and the gradient's extra collectives);
     ``overlap``: the same protein's step with ``GLAM_SHARDED_OVERLAP``
     1, 0, 0, 1 (the halo issued before the terms that do not read it,
     each step's fusion statistics deferred; and not), outputs bitwise
     equal, launches equal, gradients within twice the runs' spread, the
     eager step's ms in turns; ``giant_protein``:
     ``scripts/giant_protein_demo_torch.py --shards 2 --L 3000 --epochs
     1`` (the GCN protein tower over 3,000 residues, TripletMessage
     molecules: A 3 a forward and B 3 a step on each rank, exact); the
     kernels at those paths' shapes (A and B over the 1,000-residue
     shard's [local ; halo] table and at the giant demo's molecule
     batch); ``bench_scaling --analytic``'s lines;
  7. the AutoML solver on ``physprop_perturb`` (a fresh copy of
     ``datasets/physprop`` for each search: 12,607 molecules, label
     split 7,684 / 2,561 / 2,362): first, in a fresh process, the
     solver's card count creates no CUDA context; kernels A and B at
     (H, C) = (3, 15) and (3, 90) and C both ways at (1, 15), (1, 90)
     and (1, 180), the widths the search draws on the kernels' one-lane
     path, on a 768-molecule physprop batch and the 128-molecule demo
     batch; then the search at seed ``AUTOML_SEED`` (4 configurations x
     1 seed x 1 epoch; its configurations hold a _TripletMessage and
     kernel C users, or it fails), its low-fidelity phase at
     ``GLAM_TPU_TRIAL_SLOTS=1``, and ``glam.main`` (then the top 2 x 1
     seed x 2 epochs, the blend and PASP) at 4 slots on the one card,
     each timed, the card's utilisation sampled every 0.5 s; every trial
     must exit 0, write its final line and its result.json, replay CUDA
     graphs of its steps (its captures' seconds printed) and count the
     kernel launches its config implies in its own process; each
     trial's best_save.pt serves 37 test SMILES on the card as on the
     CPU, launches exact; the blend's and PASP's launches in this
     process exact, the blend's RMSE and PASP's three Delta_RMSE
     finite; ``EnsemblePredictor`` card vs CPU; each config's kernel
     calls checked at its trainer's batch and at the test batch;
  8. a JSON line of the kernels (times per launch on the path that
     launches each most; every path's launches, per-launch means and
     each call's numbers at its own shapes under ``by_path``, the AutoML
     paths ``automl_search``, ``automl_trials`` and ``automl_blend`` and
     the ``train_flagship_bf16``, ``train_library_bf16``,
     ``serve_jax_ckpt``, ``viz``, ``train_dp``, ``train_dp_library``,
     ``train_dp_ddi``, ``halo``, ``train_sharded_dti``,
     ``train_sharded_ring``, ``sharded_protein`` and ``giant_protein``
     among them), the
     card's line, then the final line.  Each phase's wall seconds are printed.

Exits non-zero, without the final line, if anything fails.
"""
from __future__ import annotations

import ast
import csv
import json
import math
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEMO_CSV = ROOT / "datasets" / "demo" / "raw" / "demo.csv"
TOL = 1e-4
# card against CPU, one step's parameter gradients: each tensor within
# GRAD_RTOL relative plus GRAD_ATOL times its largest entry (float32 sums
# in other orders, atomics in kernel B and in index_add_).  A tensor whose
# largest CPU entry is under GRAD_ZERO times the tree's largest is zero in
# exact arithmetic, rounding noise of terms that cancel (GlobalLAPool's
# gate bias: a softmax does not move when every logit does; 4.5e-9 of the
# tree on the CPU, against 3.7e-5 for the smallest gradient that is not
# zero); on the card it must be noise too, under GRAD_ZERO times the tree's
# largest.
GRAD_RTOL, GRAD_ATOL, GRAD_ZERO = 1e-3, 1e-4, 1e-5
TRAIN_ARGS = ["--epochs", "2", "--mol_block", "_TripletMessage"]
LIBRARY_ARGS = ["--epochs", "2", "--mol_block", "_TripletMessageLight",
                "--mol_readout", "Set2Set", "--graph_norm", "_BatchNorm",
                "--flat_norm", "_BatchNorm", "--end_norm", "_LayerNorm"]
GAT_ARGS = ["--epochs", "1", "--mol_block", "_GATConv", "--mol_readout",
            "GlobalLAPool", "--pre_norm", "_LayerNorm", "--graph_norm",
            "_GraphSizeNorm"]
PAIR_ROOTS = {"drugbank_caster": "ddi_demo", "bindingdb_c": "dti_demo",
              "ALDH1": "scr_demo"}
DDI_ARGS = ["--epochs", "2", "--mol_block", "_TripletMessage"]
DTI_ARGS = ["--epochs", "1", "--mol_block", "_TripletMessage",
            "--pro_block", "_GATConv"]
SCR_ARGS = ["--epochs", "1", "--mol_block", "_TripletMessage"]
# the AutoML phase: the solver's seed (its four sampled configurations
# hold a _TripletMessage, for kernels A and B, and kernel C users; checked
# before the search) and the search's cuts: 4 configurations x 1 seed x
# 1 epoch, then the top 2 x 1 seed x 2 epochs (the real search: 200
# configurations x 3 seeds x 30 epochs, then the top 3 x 5 seeds x 2,000)
AUTOML_SEED = 73
AUTOML_ARGS = {"n_init_configs": 4, "n_low_fidelity_seed": 1,
               "low_fidelity_epochs": 1, "n_top_blend": 2,
               "n_high_fidelity_seed": 1, "high_fidelity_epochs": 2}
PHYSPROP_CSV = ROOT / "datasets" / "physprop" / "raw" / "physprop_perturb.csv"
# the widths the search draws that kernels A and B (H = 3, C = hid) and
# C (H = 1: C = hid, or 2 hid in GlobalLAPool) take on their one-lane
# path (C % 4 != 0; hid = 15 x hid_dim_alpha, alpha in {1, 2, 3, 4, 6})
AUTOML_TRIPLET_WIDTHS = (15, 90)
AUTOML_SPMM_WIDTHS = (15, 90, 180)
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


def demo_batch(demo, n_mol=128):
    """A padded batch of the first ``n_mol`` demo molecules that
    featurize, at the pinned budgets of ``Predictor(batch_size=n_mol)``:
    the serving path's batch."""
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
    return next(iter(GraphLoader(graphs, n_mol, 1, node_budget=node_budget,
                                 edge_budget=edge_budget)))


def demo_csr(demo, n_mol=128):
    """The edge CSR of :func:`demo_batch`."""
    return batch_csr(demo_batch(demo, n_mol))


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


def random_segments(rng, n_rows=3000, long_row=5000, empty_tail=200,
                    unlisted=0):
    """A random CSR for kernel C: rows of 0-40 entries, one row of
    ``long_row`` entries, ``empty_tail`` empty rows at the end, entries in
    shuffled order, ``unlisted`` entries that no slot lists.  Returns
    (rowptr [R+1], idx [S]) int32 and the entry count M."""
    import numpy as np
    lens = rng.randint(0, 41, n_rows)
    lens[n_rows // 3] = long_row
    lens = np.concatenate([lens, np.zeros(empty_tail, lens.dtype)])
    rowptr = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=rowptr[1:])
    S = int(rowptr[-1])
    idx = rng.permutation(S + unlisted)[:S].astype(np.int32)
    return rowptr, idx, S + unlisted


def spmm_inputs(rng, rowptr, idx, M, H, C, dev):
    """Kernel C's arguments on ``dev``: logits [M, H] (with a spike of 120
    in one entry) and values [M, H*C] drawn from ``rng`` around the CSR
    (numpy arrays or tensors)."""
    import numpy as np
    import torch
    logits = (rng.randn(M, H) * 3).astype(np.float32)
    if M:
        logits[rng.randint(M)] = 120.0
    values = rng.randn(M, H * C).astype(np.float32)
    return [torch.as_tensor(a).to(dev) for a in (logits, values, rowptr, idx)]


def spmm_bound_ms(args, which):
    """Least time for kernel C's work, by bytes (a few flops per byte, so
    bytes bound it): the listed entries' logits and values, the CSR and,
    for the backward, the rows of g with entries read once; the [R, H*C]
    output, or d_logits and d_values of the listed entries, written once.
    Returns (that bound, the same with the bytes the kernels' design adds:
    the forward's [R, H] row statistics written, and the backward's reads
    of them and of the output's rows with entries)."""
    logits, values, rowptr, idx = args
    R, S = rowptr.shape[0] - 1, idx.shape[0]
    H, hc = logits.shape[1], values.shape[1]
    nbytes = 4 * (S * (H + hc) + R + 1 + S)
    if which == "fwd":
        nbytes += 4 * R * hc
        extra = 4 * R * 2 * H
    else:
        rows = int((rowptr[1:] > rowptr[:-1]).sum())
        nbytes += 4 * (rows * hc + S * (H + hc))
        extra = 4 * rows * (hc + 2 * H)
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * (nbytes + extra) / HBM_BYTES_PER_S)


def triplet_bound_ms(args, H, C):
    """Least time for the work: each needed input byte read once (the
    sender rows of xp and a_j, the rows of a_i with edges, the real edges'
    features and the CSR), the [N, H*C] output written once; against the
    flops of the real edges.  Returns (ms, 'bytes' or 'operations', ms
    with the bytes of the row statistics the design adds)."""
    import torch
    xp, a_i, a_j, edge_attr, we, wemat, rowptr, csr_snd, csr_eid = args
    N, hc, fe, E = xp.shape[0], H * C, edge_attr.shape[1], int(rowptr[-1])
    senders = int(torch.unique(csr_snd[:E]).numel()) if E else 0
    rows = int((rowptr[1:] > rowptr[:-1]).sum())
    nbytes = 4 * (N * hc                       # out
                  + senders * (hc + H)         # xp, a_j sender rows
                  + rows * H                   # a_i rows with edges
                  + E * (fe + 2) + N + 1       # edge features, CSR
                  + we.numel() + wemat.numel())
    flops = E * (2 * fe * hc + 3 * hc + 2 * fe * H + 8 * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    # the design's [N, H] row statistics, written beside the output
    t_stats = (nbytes + 4 * N * 2 * H) / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            1e3 * max(t_stats, t_ops))


def triplet_bwd_bound_ms(args, H, C):
    """Least time for kernel B's work: the sender rows of xp and a_j, the
    g and a_i rows of receivers with edges, the real edges' features and
    the CSR read once; d_xp [N, H*C], d_eh [E, H*C], d_pre [E, H] and
    d_a_i [N, H] written once; against the flops of the real edges.
    Returns (ms, 'bytes' or 'operations', ms with the bytes of the
    forward's output and row statistics that the design reads)."""
    import torch
    xp, a_i, a_j, edge_attr, we, wemat, rowptr, csr_snd, csr_eid = args
    N, hc, fe = xp.shape[0], H * C, edge_attr.shape[1]
    E, E_real = edge_attr.shape[0], int(rowptr[-1])
    senders = int(torch.unique(csr_snd[:E_real]).numel()) if E_real else 0
    rows = int((rowptr[1:] > rowptr[:-1]).sum())
    nbytes = 4 * (senders * (hc + H) + rows * (hc + H)
                  + E_real * (fe + 2) + N + 1
                  + we.numel() + wemat.numel()
                  + N * (hc + H) + E * (hc + H))
    flops = E_real * (2 * fe * hc + 2 * fe * H + 10 * hc + 2 * H * hc
                      + 12 * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    # the design's reads of the forward's output and row statistics at the
    # rows with edges
    t_stats = (nbytes + 4 * rows * (hc + 2 * H)) / HBM_BYTES_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            1e3 * max(t_stats, t_ops))


def _errors(got, want):
    """(max abs error, max error relative to max(|want|, 1))."""
    err = (got - want).abs()
    if not err.numel():
        return 0.0, 0.0
    return (float(err.max()),
            float((err / want.abs().clamp(min=1.0)).max()))


def check_kernel(which, name, csr, rng, dev, card, H=3, C=60):
    """Kernel A (``which`` 'fwd': the output and the row statistics) or B
    ('bwd', fed kernel A's output and statistics) against its plain version
    (fed the plain forward's) on the card, on random inputs drawn from
    ``rng`` around ``csr``: the errors, whether two calls are bitwise equal
    (A's outputs; B's d_eh, d_pre and d_a_i: d_xp is summed with atomics),
    and the median device times beside the bound.  Fails on disagreement
    or on results that differ between calls.  The device kernels of one
    call are traced at the end of the run (:func:`report_traced`), which
    prints the line.  Returns that line's numbers."""
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention_bwd, triplet_attention_bwd_plain,
        triplet_attention_fwd, triplet_attention_plain)

    args = kernel_inputs(rng, *csr, H, C, dev)
    N, E, slots = args[0].shape[0], int(csr[0][-1]), args[7].shape[0]
    empty = torch.from_numpy(np.diff(csr[0]) == 0).to(dev)
    # the plain versions take the rows' slots (a batch's CSR is padded to
    # its edge budget)
    real = args[:7] + [args[7][:E], args[8][:E]]
    if which == "fwd":
        kname = "triplet_fused_fwd"
        run = lambda: triplet_attention_fwd(*args, H, C)  # noqa: E731
        plain = lambda: triplet_attention_plain(*real, H, C)  # noqa: E731
        got, want, again = run(), plain(), run()
        ok = all(bool((t[empty] == 0).all()) for t in got)
        bound, bound_by, design = triplet_bound_ms(args, H, C)
    else:
        kname = "triplet_fused_bwd"
        g = torch.from_numpy(rng.randn(N, H * C).astype(np.float32)).to(dev)
        stats = triplet_attention_fwd(*args, H, C)
        plain_stats = triplet_attention_plain(*real, H, C)
        run = lambda: triplet_attention_bwd(  # noqa: E731
            *args, *stats, g, H, C)
        plain = lambda: triplet_attention_bwd_plain(  # noqa: E731
            *real, *plain_stats, g, H, C)
        got, want, again = run(), plain(), run()
        ok = bool((got[3][empty] == 0).all())
        bound, bound_by, design = triplet_bwd_bound_ms(args, H, C)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in
               zip(got[which == "bwd":], again[which == "bwd":]))
    padded = ""
    if slots > E:
        # a CSR padded to the batch's edge budget: the same results as
        # over its real slots alone, bitwise (B's d_xp: its atomics)
        if which == "fwd":
            over_real = triplet_attention_fwd(*real, H, C)
        else:
            over_real = triplet_attention_bwd(*real, *stats, g, H, C)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(got[which == "bwd":], over_real[which == "bwd":]))
        if not bitwise or not torch.allclose(got[0], over_real[0],
                                             rtol=1e-6, atol=1e-6):
            fail(f"{kname} on {name}: the CSR padded to {slots} slots "
                 f"and its {E} real slots give other results")
        padded = f" padded_csr_bitwise={bitwise} ({slots} slots)"
    errs = [_errors(a, b) for a, b in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    max_rel = max(e[1] for e in errs)
    ok = ok and all(torch.allclose(a, b, rtol=TOL, atol=TOL)
                    for a, b in zip(got, want))
    k_ms = device_ms(run)
    p_ms = device_ms(plain, reps=20, sleep_cycles=20_000_000)
    longest = int(np.diff(csr[0]).max()) if N else 0
    line = (f"kernel {kname} [{name}] N={N} E={args[3].shape[0]} "
            f"E_real={E} H={H} C={C} longest_row={longest}: "
            f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
            f"(tol {TOL}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={bound:.4f} ({bound_by}) "
            f"share_of_bound={bound / k_ms:.3f} "
            f"bound_with_row_stats_ms={design:.4f}{padded}")
    if not ok:
        print(line)
        fail(f"{kname} disagrees with its plain version on {name}: "
             f"max_abs_err {max_abs}")
    if not same:
        print(line)
        fail(f"{kname} on {name}: two calls differ")
    out = {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": bound, "bound_by": bound_by,
           "bound_with_row_stats_ms": design, "deterministic": same,
           "line": f"{line} deterministic={same} ({card})"}
    TRACED.append(("triplet", which, name, [t.cpu() for t in args], (H, C),
                   out))
    return out


def spmm_reference(args, g=None):
    """Kernel C's plain forward on ``args`` (logits, values, rowptr, idx):
    [out, row_max, row_inv]; or with the cotangent ``g`` its plain
    backward from the plain forward's results: [d_logits, d_values];
    computed in float64 and cast back to float32: the reference a
    kernel's result is held against, so that its error is the kernel's
    own and not the float32 plain version's rounding (whose ``index_add_``
    sums in another order on every call)."""
    from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
        segment_softmax_spmm_bwd_plain, segment_softmax_spmm_plain)
    logits, values, rowptr, idx = args
    wide = (logits.double(), values.double(), rowptr, idx)
    fwd = segment_softmax_spmm_plain(*wide)
    if g is None:
        return [t.float() for t in fwd]
    return [t.float() for t in segment_softmax_spmm_bwd_plain(
        *wide, *fwd, g.double())]


def device_kernels(fn, calls: int = 4, tries: int = 5):
    """The device kernels (and fills and copies) that one call of ``fn``
    runs, from a ``torch.profiler`` trace of ``calls`` calls: their
    names, in order.  A trace whose kernels do not repeat call by call
    (one that lost device records, see :func:`traced_kernels`) is taken
    again, up to ``tries`` times; fails if none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        per = names[:len(names) // calls]
        if per and per * calls == names:
            return per
    fail(f"{tries} traces of {calls} calls each: the last held device "
         f"kernels {names}, not the same kernels in each call")


def traced_kernels(cases):
    """The device kernels of one call of each of ``cases`` ((kind, which,
    arguments, (H, C)): kind 'spmm' for kernel C, 'triplet' for kernels A
    and B; which 'fwd', 'bwd' or 'both'), each from a profiler trace
    (:func:`device_kernels`), all taken in one fresh process
    (``chip_smoke.py --trace``): in this one, once the training runs had
    run, traces lost device records (3 of 4 kernels, or none, on the
    H100).  Returns [{'fwd': names, 'bwd': names}] in the order of
    ``cases``, with the directions each case asks for."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "calls.pt"
        torch.save([(kind, which, [t.cpu() for t in args], widths)
                    for kind, which, args, widths in cases], path)
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--trace", str(path)], capture_output=True,
                              text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"the trace process failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def trace_main(path):
    """``chip_smoke.py --trace FILE``: each call saved in FILE (see
    :func:`traced_kernels`) on the card, traced by :func:`device_kernels`
    (a backward from its forward's results, with g all ones); prints
    [{'fwd': names, 'bwd': names}]."""
    import torch
    from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
        segment_softmax_spmm_bwd, segment_softmax_spmm_fwd)
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention_bwd, triplet_attention_fwd)
    traced = []
    for kind, which, saved, (H, C) in torch.load(path):
        args = [t.cuda() for t in saved]
        if kind == "spmm":
            g = torch.ones(args[2].shape[0] - 1, args[1].shape[1],
                           device="cuda")
            fwd = lambda: segment_softmax_spmm_fwd(*args)  # noqa: E731
            stats = fwd()
            bwd = lambda: segment_softmax_spmm_bwd(  # noqa: E731
                *args, *stats, g)
        else:
            g = torch.ones(args[0].shape[0], H * C, device="cuda")
            fwd = lambda: triplet_attention_fwd(*args, H, C)  # noqa: E731
            stats = fwd()
            bwd = lambda: triplet_attention_bwd(  # noqa: E731
                *args, *stats, g, H, C)
        traced.append({w: device_kernels(fn) for w, fn in
                       (("fwd", fwd), ("bwd", bwd))
                       if which in (w, "both")})
    print(json.dumps(traced))


# every kernel check of the run whose device kernels are traced at its
# end (:func:`report_traced`), in order: (kind, which, call name, its
# arguments on the CPU, (H, C), the numbers or {'fwd': ..., 'bwd': ...})
TRACED = []
# device kernels a call must run: kernel A one; kernel B two, the zero
# fill of d_xp (summed into with atomics) and the kernel; kernel C one
# each way (a backward with unlisted entries also zero-fills)
TRIPLET_KERNELS = {"fwd": 1, "bwd": 2}


def check_spmm(which, name, args, dev, card):
    """Kernel C's forward (``which`` 'fwd') or backward ('bwd', from the
    forward kernel's output and row statistics) on the card on ``args``
    (logits, values, rowptr, idx) against its plain version computed in
    float64 (:func:`spmm_reference`): the errors, whether two calls are
    bitwise equal, and the median device times of the kernel and of the
    float32 plain version beside the bound.  Fails on disagreement or on
    results that differ between calls.  Returns that line's numbers and,
    under 'line', its text without the device kernels, which
    :func:`report_traced` adds and prints."""
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
        segment_softmax_spmm_bwd, segment_softmax_spmm_bwd_plain,
        segment_softmax_spmm_fwd, segment_softmax_spmm_plain)
    logits, values, rowptr, idx = args
    R, S, M = rowptr.shape[0] - 1, idx.shape[0], logits.shape[0]
    H, hc = logits.shape[1], values.shape[1]
    if which == "fwd":
        kname, g = "segment_softmax_spmm_fwd", None
        run = lambda: list(segment_softmax_spmm_fwd(*args))  # noqa: E731
        plain = lambda: segment_softmax_spmm_plain(*args)  # noqa: E731
    else:
        kname = "segment_softmax_spmm_bwd"
        g = torch.from_numpy(np.random.RandomState(R).randn(R, hc).astype(
            np.float32)).to(dev)
        stats = segment_softmax_spmm_fwd(*args)
        plain_stats = segment_softmax_spmm_plain(*args)
        run = lambda: list(segment_softmax_spmm_bwd(  # noqa: E731
            *args, *stats, g))
        plain = lambda: segment_softmax_spmm_bwd_plain(  # noqa: E731
            *args, *plain_stats, g)
    got, want = run(), spmm_reference(args, g)
    again = run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [_errors(a, b) for a, b in zip(got, want)]
    max_abs = max(e[0] for e in errs)
    ok = all(torch.allclose(a, b, rtol=TOL, atol=TOL)
             for a, b in zip(got, want))
    bound, design = spmm_bound_ms(args, which)
    k_ms = device_ms(run)
    p_ms = device_ms(plain, reps=20, sleep_cycles=20_000_000)
    longest = int((rowptr[1:] - rowptr[:-1]).max()) if R else 0
    line = (f"kernel {kname} [{name}] R={R} S={S} M={M} H={H} C={hc // H} "
            f"longest_row={longest}: max_abs_err={max_abs:.3e} (tol {TOL}) "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={bound:.4f} "
            f"(bytes) share_of_bound={bound / k_ms:.3f} "
            f"bound_with_row_stats_ms={design:.4f}")
    if not ok:
        print(line)
        fail(f"{kname} disagrees with its plain version on {name}: "
             f"max_abs_err {max_abs}")
    if not same:
        print(line)
        fail(f"{kname} on {name}: two calls differ")
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "bound_with_row_stats_ms": design, "deterministic": same,
            "line": f"{line} deterministic={same} ({card})"}


def check_spmm_both(name, args, dev, card):
    out = {w: check_spmm(w, name, args, dev, card) for w in ("fwd", "bwd")}
    TRACED.append(("spmm", "both", name, [t.cpu() for t in args], (0, 0),
                   out))
    return out


def report_traced():
    """Trace the device kernels of one call of each check of the run
    (:func:`traced_kernels`, one process for all), print each check's line
    with them, and fail unless each call runs the kernels its design
    states: kernel A one, kernel B two (:data:`TRIPLET_KERNELS`), kernel
    C's forward one and its backward one with every entry listed (S == M;
    it also zero-fills where some are not)."""
    traced = traced_kernels([(kind, which, args, widths) for
                             kind, which, _, args, widths, _ in TRACED])
    for (kind, which, name, args, _, out), kernels in zip(TRACED, traced):
        for w, k in kernels.items():
            r = out[w] if kind == "spmm" else out
            r["device_kernels"] = len(k)
            head, tail = r.pop("line").split(" deterministic=")
            print(f"{head} device_kernels={len(k)} {k} deterministic={tail}")
            if kind == "spmm":
                want = 1 if w == "fwd" or args[3].shape[0] == args[0].shape[
                    0] else 2
                kname = f"segment_softmax_spmm_{w}"
            else:
                want, kname = TRIPLET_KERNELS[w], f"triplet_fused_{w}"
            if len(k) != want:
                fail(f"{kname} on {name}: one call ran {len(k)} device "
                     f"kernels {k}, not {want}")


def check_spmm_calls(prefix, batch, block, readout, hid, rng, dev, card):
    """Kernel C forward and backward at the shapes of each of its calls
    in a model on ``batch`` (a padded ``GraphBatch``): the conv's
    (``block`` '_TripletMessageLight' over every edge slot, '_GATConv'
    over edge slots and self-loops; [slots, 1] logits, [slots, hid]
    values) and the readout's ('Set2Set' [N, 1] x [N, hid], 'GlobalLAPool'
    [N, 1] x [N, 2 hid], rows the graphs, the padding graph the longest).
    Returns {call name: {'fwd': numbers, 'bwd': numbers}}."""
    from glam_tpu_torch.data.graph import graph_csr
    conv = {"_TripletMessageLight": ("light", batch.padded_csr,
                                     batch.num_edges),
            "_GATConv": ("gat", batch.self_loop_csr,
                         batch.num_edges + batch.num_nodes)}[block]
    width = {"Set2Set": ("set2set", hid),
             "GlobalLAPool": ("lapool", 2 * hid)}[readout]
    name, (rowptr, idx), m = conv
    out = {name: check_spmm_both(f"{prefix}_{name}", spmm_inputs(
        rng, rowptr, idx, m, 1, hid, dev), dev, card)}
    name, c = width
    out[name] = check_spmm_both(f"{prefix}_{name}", spmm_inputs(
        rng, *graph_csr(batch.n_node, batch.num_nodes), batch.num_nodes, 1,
        c, dev), dev, card)
    return out


def kernel_phase(dev, demo, card):
    """Kernels A and B on the serving path's batch and on a random batch
    with empty rows and an in-degree-500 hub (also at H*C = 512 with 8
    heads); kernel C at the serving
    path's calls (TripletMessageLight over every edge slot, the last
    node's padded edges one long row; Set2Set over the graphs of a
    128-molecule batch at the pinned budgets, its padding graph one long
    row) and on random CSRs with empty rows and a 5,000-entry row.  The
    training paths' batches are checked in :func:`training_phase`,
    :func:`library_phase` and :func:`gat_phase`, from each trainer's
    loader."""
    import numpy as np
    rng = np.random.RandomState(0)
    hub = random_csr(rng)
    out = {"fwd": {"serve": check_kernel("fwd", "demo128", demo_csr(demo),
                                         rng, dev, card),
                   "hub": check_kernel("fwd", "random_hub_empty", hub, rng,
                                       dev, card)},
           "bwd": {"hub": check_kernel("bwd", "random_hub_empty", hub, rng,
                                       dev, card)}}
    for w in ("fwd", "bwd"):      # H*C = 512, 8 heads
        out[w]["h8_c64"] = check_kernel(w, "random_h8_c64", hub, rng, dev,
                                        card, 8, 64)
    spmm = check_spmm_calls("serve", demo_batch(demo), "_TripletMessageLight",
                            "Set2Set", 60, rng, dev, card)
    for H, C in ((3, 16), (8, 64)):
        rowptr, idx, M = random_segments(rng)
        spmm[f"random_h{H}_c{C}"] = check_spmm_both(
            f"random_h{H}_c{C}", spmm_inputs(rng, rowptr, idx, M, H, C, dev),
            dev, card)
    out["spmm"] = spmm
    return out


def function_grads(host, g, H, C, dev, dtype):
    """The gradients of the six differentiable inputs of the
    triplet-attention Function (kernels A and B on the card, the plain
    versions on the CPU) for the cotangent ``g``, with the float inputs
    in ``dtype`` on ``dev``; returned on the CPU."""
    from glam_tpu_torch.ops.kernels.triplet_fused import triplet_attention
    t = [a.clone().to(dev) for a in host]
    t = [a.to(dtype) if a.is_floating_point() else a for a in t]
    for a in t[:6]:
        a.requires_grad_(True)
    triplet_attention(*t, H, C).backward(g.to(dev, dtype))
    return [a.grad.cpu() for a in t[:6]]


def function_on_card_vs_cpu(dev, csr, rng, H=3, C=60):
    """The differentiable op (kernels A and B on the card) against the
    same op on the CPU (the plain versions, in float64: the a_i gradient
    of a long row is a difference of nearly equal sums, which float32
    leaves up to several times the tolerance off), on the training
    batch."""
    import numpy as np
    import torch
    host = kernel_inputs(rng, *csr, H, C, "cpu")
    g = torch.from_numpy(rng.randn(host[0].shape[0], H * C).astype(
        np.float32))
    card = function_grads(host, g, H, C, dev, torch.float32)
    want = function_grads(host, g, H, C, "cpu", torch.float64)
    worst = 0.0
    for name, a, b in zip(("xp", "a_i", "a_j", "edge_attr", "we", "wemat"),
                          card, want):
        a = a.double()
        scale = max(float(b.abs().max()), 1.0)
        err = float((a - b).abs().max()) / scale
        worst = max(worst, err)
        if not torch.allclose(a, b, rtol=TOL, atol=1e-5 * scale):
            fail(f"triplet_attention gradient {name}: card and CPU differ "
                 f"by {err:.3e} of its scale")
    print(f"triplet_attention autograd.Function card vs CPU in float64 "
          f"(train_batch): max gradient error {worst:.3e} of each "
          f"tensor's scale (tol rtol {TOL}, atol 1e-5 x scale)")


def rows_apart(got, want, rowptr, rtol, atol, most=12):
    """The rows of ``got`` and ``want`` ([N, ...]) that differ by more
    than atol + rtol |want|, each with its in-degree and the span of
    32-slot chunks its CSR slots lie in (``rowptr``), as text."""
    got = got.detach().double().cpu().reshape(got.shape[0], -1)
    want = want.detach().double().cpu().reshape(want.shape[0], -1)
    bad = ((got - want).abs() > atol + rtol * want.abs()).any(1)
    bad = bad.nonzero().flatten().tolist()
    lines = [f"{len(bad)} rows apart"]
    for r in bad[:most]:
        beg, end = int(rowptr[r]), int(rowptr[r + 1])
        span = (f"chunks {beg // 32}-{(end - 1) // 32}" if end > beg
                else "no slots")
        lines.append(f"  row {r}: in-degree {end - beg}, {span}; got "
                     f"{got[r, :4].tolist()} want {want[r, :4].tolist()}")
    return "\n".join(lines)


def tickets_zero(where):
    """Fail unless every ticket buffer of kernels A, B and C is zero."""
    import torch
    from glam_tpu_torch.ops.kernels import common
    torch.cuda.synchronize()
    dirty = common.dirty_tickets()
    if dirty:
        fail(f"{where}: ticket buffers left nonzero: {dirty}")


STRESS_ROUNDS = 40


def stress_cases():
    """The CSRs of the card tests' kernel A/B checks that hold rows of
    more than 32 edges: (name, csr, H, C, seed)."""
    import numpy as np
    rng = np.random.RandomState(2)

    def lens_csr(lens):
        rowptr = np.zeros(len(lens) + 1, np.int32)
        np.cumsum(lens, out=rowptr[1:])
        S = int(rowptr[-1])
        return (rowptr, rng.randint(0, len(lens), S).astype(np.int32),
                rng.permutation(S).astype(np.int32),
                rng.randn(S, 4).astype(np.float32))

    hub300 = random_csr(rng, n_graphs=20, max_n=30, tail=64, hub=300)
    return [("hub300", hub300, 3, 60, 2),
            ("hub300_h8_c64", hub300, 8, 64, 3),
            ("hub300_h3_c90", hub300, 3, 90, 4),
            ("hub500", random_csr(rng, n_graphs=80), 3, 60, 5),
            ("one_boundary", lens_csr(np.r_[np.ones(20, int), 40,
                                            rng.randint(1, 5, 50)]),
             3, 60, 6),
            ("many_blocks", lens_csr(np.r_[rng.randint(0, 5, 100), 3000,
                                           rng.randint(0, 5, 100)]),
             3, 60, 7)]


def ab_stress(dev, rounds=STRESS_ROUNDS, label="stress"):
    """Kernels A and B again and again on the CSRs with long rows
    (:func:`stress_cases`), first on one stream in the card tests'
    order, then on two streams at once: every call's outputs bitwise
    those of the first call (B: d_eh, d_pre, d_a_i), the autograd
    Function's gradients within the card test's tolerance of the CPU's
    (the rows apart printed on a failure), and every ticket buffer zero
    after every call.  Returns the number of calls checked."""
    import numpy as np
    import torch
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention, triplet_attention_bwd, triplet_attention_fwd)

    cases, f32_worst = [], 0.0
    for name, csr, H, C, seed in stress_cases():
        rng = np.random.RandomState(seed)
        host = kernel_inputs(rng, *csr, H, C, "cpu")
        g = torch.from_numpy(rng.randn(host[0].shape[0], H * C).astype(
            np.float32))
        cpu_grads = function_grads(host, g, H, C, "cpu", torch.float64)
        # the float32 CPU gradient, the reference before: how far its
        # a_i lies from float64, at one thread and at all
        threads = torch.get_num_threads()
        for n in (1, threads):
            torch.set_num_threads(n)
            a = function_grads(host, g, H, C, "cpu", torch.float32)[1]
            b = cpu_grads[1]
            scale = max(float(b.abs().max()), 1.0)
            f32_worst = max(f32_worst, float(
                ((a - b).abs() / (1e-5 * scale + TOL * b.abs())).max()))
        torch.set_num_threads(threads)
        args = [a.to(dev) for a in host]
        stats = triplet_attention_fwd(*args, H, C)
        bwd = triplet_attention_bwd(*args, *stats, g.to(dev), H, C)
        cases.append((name, csr, H, C, host, g.to(dev), cpu_grads, args,
                      [t.clone() for t in stats],
                      [t.clone() for t in bwd[1:]]))
    tickets_zero(f"{label}: first calls")

    def check(case, where):
        name, csr, H, C, host, g, cpu_grads, args, stats, bwd = case
        got = triplet_attention_fwd(*args, H, C)
        back = triplet_attention_bwd(*args, *got, g, H, C)
        return name, csr, H, C, stats, bwd, got, back, where

    def verify(name, csr, H, C, stats, bwd, got, back, where):
        for what, a, b in zip(("out", "row_max", "row_inv"), got, stats):
            if not torch.equal(a, b):
                fail(f"{where} [{name}]: kernel A's {what} differs from "
                     "the first call's:\n" + rows_apart(a, b, csr[0], 0, 0))
        for what, a, b in zip(("d_eh", "d_pre", "d_a_i"), back[1:], bwd):
            if not torch.equal(a, b):
                rows = csr[0] if what == "d_a_i" else None
                fail(f"{where} [{name}]: kernel B's {what} differs from "
                     "the first call's" + (":\n" + rows_apart(
                         a, b, rows, 0, 0) if rows is not None else ""))

    calls = 0
    for r in range(rounds):
        for case in cases:
            name, csr, H, C, host, g, cpu_grads, *_ = case
            verify(*check(case, f"{label} round {r}"))
            grads = function_grads(host, g, H, C, dev, torch.float32)
            for what, a, b in zip(("xp", "a_i", "a_j", "edge_attr", "we",
                                   "wemat"), grads, cpu_grads):
                a = a.double()
                scale = max(float(b.abs().max()), 1.0)
                if not torch.allclose(a, b, rtol=TOL, atol=1e-5 * scale):
                    fail(f"{label} round {r} [{name}]: the gradient of "
                         f"{what} card vs CPU:\n" + rows_apart(
                             a, b, csr[0], TOL, 1e-5 * scale))
            tickets_zero(f"{label} round {r} [{name}]")
            calls += 4
    # two streams at once: case i on one while case i + 1 runs on the
    # other, no synchronisation between the launches
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for r in range(rounds):
        for i in range(len(cases)):
            pending = []
            for k, s in enumerate(streams):
                case = cases[(i + k) % len(cases)]
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    pending.append(check(case, f"{label} two streams round "
                                         f"{r} stream {k}"))
            torch.cuda.synchronize()
            for p in pending:
                verify(*p)
            tickets_zero(f"{label} two streams round {r}")
            calls += 4
    print(f"{label}: kernels A and B {calls} calls over {rounds} rounds of "
          f"{len(cases)} CSRs with rows of 40-3,000 edges, one stream then "
          "two at once: every call bitwise equal to the first, the "
          "Function's gradients within rtol 1e-4 + atol 1e-5 x scale of "
          "the CPU's in float64, every ticket buffer zero after every "
          "call; the float32 CPU gradient of a_i (the reference before) "
          f"lies up to {f32_worst:.3f} x that tolerance from float64")
    return calls


def serving_phase(dev, demo, card):
    import numpy as np
    import torch
    from glam_tpu_torch.nn.model import Architecture, ModelConfig
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
    pred.predict_smiles(demo[:16])     # warm-up: its batch runs eagerly
    torch.cuda.synchronize()

    reset_counts()
    outs, secs = {}, {}
    for name, smis in requests.items():
        t0 = time.perf_counter()
        outs[name] = pred.predict_smiles(smis)
        secs[name] = time.perf_counter() - t0
    launches = read_counts()
    st = served_graphs("serving", pred, card)

    n_batches = 0
    for name, smis in requests.items():
        items, valid = request_items(pred, smis)
        n_batches += len(items)
        out = outs[name]
        if out.shape != (len(smis), 1):
            fail(f"{name}: output shape {out.shape}")
        if not (np.isfinite(out[valid]).all() and np.isnan(out[~valid]).all()):
            fail(f"{name}: valid rows not finite or invalid rows not NaN")
        replays_bitwise(f"serving {name}", pred, smis, out)
        want = cpu.predict_smiles(smis)
        err = float(np.nanmax(np.abs(out - want))) if valid.any() else 0.0
        if not np.allclose(out, want, rtol=TOL, atol=TOL, equal_nan=True):
            fail(f"{name}: card and CPU predictions differ by {err}")
        print(f"request {name}: {len(smis)} SMILES ({int(valid.sum())} "
              f"valid) in {len(items)} batches: latency_s="
              f"{secs[name]:.4f} mol_per_s={len(smis) / secs[name]:.1f} "
              f"max_abs_err_vs_cpu={err:.3e}; replayed rows bitwise equal "
              "to the eager forward's")
        for i, (b,) in enumerate(items):
            print(f"  batch {i}: graphs={int(b.graph_mask.sum())} "
                  f"real_nodes={int(b.node_mask.sum())}/{b.num_nodes} "
                  f"real_edges={b.num_real_edges}/{b.num_edges}")
    check_counts("flagship serving", launches,
                 {"triplet_fused_fwd": cfg.message_steps * n_batches})
    if st["captures"] != 1 or st["signatures"] != 1:
        fail(f"flagship serving: the pinned budgets' batches took "
             f"{st['captures']} captures and {st['signatures']} "
             "signatures; expected 1 and 1")
    total = sum(len(s) for s in requests.values())
    print(f"serving: {total} SMILES in {sum(secs.values()):.4f} s "
          f"({total / sum(secs.values()):.1f} mol/s); triplet_fused_fwd "
          f"launches={launches['triplet_fused_fwd']} = {cfg.message_steps}"
          f" steps x {n_batches} batches, replays included")
    request_turns("serving", pred, requests, "mol", card)
    breakdown(pred, demo, card)
    return launches


def served_graphs(label, pred, card):
    """Fail unless ``pred`` (a predictor on the card, or an ensemble of
    them) served through replayed CUDA graphs; print and return their
    statistics."""
    st = pred.graph_stats
    if not st or st["replays"] == 0:
        fail(f"{label}: not served through replayed CUDA graphs: {st}")
    print(f"{label}: served_graphs=true captures={st['captures']} "
          f"replays={st['replays']} released={st['released']} "
          f"signatures={st['signatures']} capture_s={st['capture_s']:.3f} "
          f"warmup_s={st['warmup_s']:.3f} pool_bytes={st['pool_bytes']} "
          f"({st['pool_bytes'] / 2**20:.1f} MiB) ({card})")
    return st


def request_items(pred, request):
    """(the loader items, tuples of CPU GraphBatches, that ``pred``
    serves ``request`` in; the mask of the entries it resolves): SMILES
    for a ``Predictor``, pairs for a ``PairPredictor`` (at its floors)."""
    import numpy as np
    if hasattr(pred, "samples"):
        resolved = pred.samples(request)
        valid = [s for s in resolved if s is not None]
        items = list(pred.loader(valid)) if valid else []
    else:
        resolved = pred.featurize(request)
        valid = [g for g in resolved if g is not None]
        items = [(b,) for b in pred.batches(valid)] if valid else []
    return items, np.asarray([r is not None for r in resolved], bool)


def eager_rows(pred, items):
    """The valid rows of ``pred.model`` on each loader item, run eagerly
    on the card as the predictors served before their forwards were
    captured: the batch copied to the card field by field, the forward
    op by op, the output copied back."""
    import numpy as np
    import torch
    outs = []
    with torch.inference_mode():
        for parts in items:
            out = pred.model(*(p.to(pred.device) for p in parts)).cpu()
            outs.append(out.numpy()[parts[0].graph_mask.numpy()])
    return np.concatenate(outs)


def replays_bitwise(label, pred, request, got):
    """Fail unless ``got``, what ``pred`` served for ``request`` (its
    graphs' replays, and a new signature's eager first batch on the
    capture's stream), equals its eager forward on the card bitwise."""
    import numpy as np
    items, valid = request_items(pred, request)
    if not items:
        return
    want = eager_rows(pred, items)
    if not np.array_equal(got[valid], want):
        fail(f"{label}: served rows differ from the eager forward's on the "
             f"card by {np.abs(got[valid] - want).max()} (bitwise expected)")


def request_turns(label, pred, requests, unit, card):
    """Each request served eagerly (``request_items`` and ``eager_rows``:
    the same featurizing and padding, the forwards op by op) and through
    the predictor's graphs, in turns (eager, replayed, replayed, eager):
    latency and ``unit``/s of each."""
    serve = (pred.predict_pairs if hasattr(pred, "predict_pairs")
             else pred.predict_smiles)
    turns = {"eager": lambda r: eager_rows(pred, request_items(pred, r)[0]),
             "replayed": serve}
    for name, req in requests.items():
        secs = {"eager": [], "replayed": []}
        for turn in ("eager", "replayed", "replayed", "eager"):
            t0 = time.perf_counter()
            turns[turn](req)
            secs[turn].append(time.perf_counter() - t0)
        print(f"{label} request {name} in turns ({len(req)} {unit}): "
              + "; ".join(f"{k} latency_s " + ", ".join(
                  f"{v:.4f}" for v in vs) + f" = {unit}_per_s " + ", ".join(
                  f"{len(req) / v:.1f}" for v in vs)
                  for k, vs in secs.items()) + f" ({card})")


def served_batch_timing(label, pred, parts, card, top=8):
    """One served batch (a loader item on the CPU) in turns: eager (the
    batch copied field by field, the forward op by op, the output back)
    and replayed (one pinned copy, the graph's replay, the output back):
    each's median host ms, a profile's busy ms and kernels, and the idle
    share (1 - busy / host)."""
    import torch
    fns = {"eager": lambda: pred.model(
               *(p.to(pred.device) for p in parts)).cpu(),
           "replayed": lambda: pred.graphs(parts).cpu()}
    ms = {"eager": [], "replayed": []}
    with torch.inference_mode():
        fns["replayed"]()
        fns["replayed"]()            # its signature captured, if new
        for turn in ("eager", "replayed", "replayed", "eager"):
            ms[turn].append(host_step_ms(fns[turn]))
        prof = {k: print_profile(f"{label} one served batch, {k}", fn, top)
                for k, fn in fns.items()}
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"served batch [{label}]: host ms in turns eager "
          f"{', '.join(f'{v:.4f}' for v in ms['eager'])}, replayed "
          f"{', '.join(f'{v:.4f}' for v in ms['replayed'])}; busy ms eager "
          f"{prof['eager']['busy_ms']:.4f} over {prof['eager']['kernels']} "
          f"kernels, replayed {prof['replayed']['busy_ms']:.4f} over "
          f"{prof['replayed']['kernels']}; idle share eager "
          f"{1 - prof['eager']['busy_ms'] / med['eager']:.3f}, replayed "
          f"{1 - prof['replayed']['busy_ms'] / med['replayed']:.3f} ({card})")
    return {"host_ms": med, "busy_ms": {k: p["busy_ms"]
                                        for k, p in prof.items()}}


def breakdown(pred, demo, card):
    """Where one request's time goes: featurize, pad, then the forwards
    eagerly (to the device, forward) and replayed (load, replay, output
    back), on the host clock, each stage ending in a synchronize; then a
    served batch eager against replayed (``served_batch_timing``)."""
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
        for b in batches:
            pred.graphs((b,)).cpu()
        t5 = time.perf_counter()
        fwd_ms = device_ms(lambda: pred.model(moved[0]), reps=10,
                           warmup=2, sleep_cycles=100_000_000)
    print(f"breakdown demo_all: featurize_s={t1 - t0:.4f} pad_s="
          f"{t2 - t1:.4f} to_device_s={t3 - t2:.4f} forward_s="
          f"{t4 - t3:.4f} (eager) replayed_forward_s={t5 - t4:.4f} (load, "
          f"replay, output back) ({len(batches)} batches); one batch "
          f"forward device_ms={fwd_ms:.4f} ({card})")
    print(f"serving featurize [demo_all, native]: {len(demo)} SMILES in "
          f"{t1 - t0:.4f} s = {len(demo) / (t1 - t0):.1f} mol/s; "
          f"{PYTHON_FEATURIZE}")
    served_batch_timing("flagship", pred, (batches[0],), card)


def print_profile(label, fn, top=8):
    """A ``torch.profiler`` top-``top`` of one call of ``fn``, by self
    device time; then the call's device kernels from the trace: their
    count, the sum of their durations (the time the card is busy) and the
    span from the first's start to the last's end.  Returns those three
    ({'kernels', 'busy_ms', 'span_ms'})."""
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
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e.time_range for e in device]
    busy = sum(k.elapsed_us() for k in kernels) / 1e3
    # NCCL's kernels spin while they wait for a peer: the busy time
    # without them is the step's own work
    own = sum(e.time_range.elapsed_us() for e in device
              if "nccl" not in e.name.lower()) / 1e3
    span = (max(k.end for k in kernels) - min(k.start for k in kernels)) \
        / 1e3
    print(f"profile {label}: device_time_us={total:.1f}; {len(kernels)} "
          f"device kernels, busy_ms={busy:.4f} (without the collectives' "
          f"kernels {own:.4f}) over a span of {span:.4f} ms (first start "
          f"to last end)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.key[:60]}: device_us={e.self_device_time_total:.1f} "
              f"calls={e.count}")
    return {"kernels": len(kernels), "busy_ms": busy,
            "busy_own_ms": own, "span_ms": span}


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


def reset_counts():
    """Set every kernel's launch count to 0."""
    from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
        segment_softmax_spmm, segment_softmax_spmm_bwd)
    from glam_tpu_torch.ops.kernels.triplet_fused import (
        triplet_attention, triplet_attention_bwd)
    for counted in (triplet_attention, triplet_attention_bwd,
                    segment_softmax_spmm, segment_softmax_spmm_bwd):
        counted.launches = 0


def read_counts():
    """{kernel name: launches since the last reset_counts()}."""
    from glam_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def check_counts(label, got, want):
    """Fail unless each kernel's launches equal ``want`` (0 if absent)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times; expected "
                 f"{want.get(name, 0)}")


def run_cli(tmp, flags, label, dataset="demo"):
    """``glam_tpu_torch.run.main`` on ``dataset`` (the demo dataset, or a
    pair dataset of :data:`PAIR_ROOTS` on its bundled corpus) with
    ``flags``, on the card; the counts are read around this run alone.
    Returns the trainer, the launches, the optimizer steps and the number
    of forwards (steps, validation each epoch, then validation and test
    of the best checkpoint)."""
    import torch
    from glam_tpu_torch import run
    if dataset == "demo":
        root = Path(tmp) / "demo"
        if not root.exists():
            shutil.copytree(DEMO_CSV.parent, root / "raw")
        data = ["--dataset", "demo", "--loss", "bcel", "--dataset_root",
                str(root)]
    else:
        data = ["--dataset", dataset, "--dataset_root",
                str(ROOT / "datasets" / PAIR_ROOTS[dataset])]
    argv = data + ["--work_dir", str(Path(tmp) / label)] + flags
    print(f"training [{label}]: python -m glam_tpu_torch.run "
          f"{' '.join(argv)}")
    reset_counts()
    t0 = time.perf_counter()
    trainer = run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    last = (trainer.log_save_dir / "log.txt").read_text().strip() \
        .splitlines()[-1]
    parse_final_line(last)
    steps = sum(e["steps"] for e in trainer.epoch_stats)
    forwards = (steps + len(trainer.epoch_stats) * len(trainer.valid_loader)
                + len(trainer.valid_loader) + len(trainer.test_loader))
    result = json.loads((trainer.log_save_dir / "result.json").read_text())
    if not result["step_graphs"] or trainer.step_graphs is None:
        fail(f"training [{label}]: the steps ran eagerly: "
             f"{result['step_graphs_reason']}")
    gs = result["step_graph_stats"]
    print(f"training [{label}]: step_graphs=true at --scan_steps "
          f"{result['scan_steps']}: {gs['captures']} captures in "
          f"{gs['capture_s']:.3f} s, eager warm-up groups "
          f"{gs['warmup_s']:.3f} s, {gs['replays']} replays, graph pools "
          f"{gs['pool_bytes'] / 2**20:.1f} MiB ({card_line()})")
    cfg = trainer.model.cfg
    towers = (f" protein tower {cfg.pro_block} {cfg.pro_readout}"
              if getattr(trainer.model, "hetero", False) else "")
    print(f"training [{label}]: block={cfg.mol_block} readout="
          f"{cfg.mol_readout}{towers} norms pre={cfg.pre_norm} graph="
          f"{cfg.graph_norm} flat={cfg.flat_norm} end={cfg.end_norm} "
          f"hid={cfg.hid_dim} steps={cfg.message_steps} e_dim={cfg.e_dim} "
          f"optimizer steps={steps} forwards={forwards} wall_s={wall:.2f}; "
          f"launches {json.dumps(launches)}")
    for i, e in enumerate(trainer.epoch_stats):
        print(f"  epoch {i}: {e['steps']} steps, {e['molecules']} "
              f"samples in {e['seconds']:.3f} s = "
              f"{e['molecules'] / e['seconds']:.1f} samples/s")
    print(f"final line [{label}]: {last}")
    return trainer, launches, steps, forwards


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def training_phase(dev, card, tmp):
    """Train the flagship through the CLI, then check its counts, its
    checkpoint, one step's gradients against the CPU, and time its
    steps."""
    import numpy as np
    from glam_tpu_torch.serve import Predictor

    trainer, launches, steps, forwards = run_cli(tmp, TRAIN_ARGS, "flagship")
    cfg = trainer.model.cfg
    check_counts("flagship training", launches, {
        "triplet_fused_bwd": cfg.message_steps * steps,
        "triplet_fused_fwd": cfg.message_steps * forwards})
    print(f"training [flagship]: H={trainer.model.mol.conv.conv.heads} "
          f"launches triplet_fused_bwd={launches['triplet_fused_bwd']} = "
          f"{cfg.message_steps} x {steps} steps, triplet_fused_fwd="
          f"{launches['triplet_fused_fwd']} = {cfg.message_steps} x "
          f"{forwards} forwards ({card})")

    # the trained checkpoint serves on the card as on the CPU
    run_dir = trainer.log_save_dir
    smis = read_demo()[:64]
    on_card = Predictor.from_checkpoint(run_dir, device=dev)
    on_cpu = Predictor.from_checkpoint(run_dir, device="cpu")
    a, b = on_card.predict_smiles(smis), on_cpu.predict_smiles(smis)
    if not (np.isfinite(a).all() and np.allclose(a, b, rtol=TOL,
                                                 atol=TOL)):
        fail(f"trained best_save.pt: card and CPU predictions differ by "
             f"{np.abs(a - b).max()}")
    replays_bitwise("serving [flagship]", on_card, smis, a)
    served_graphs("serving the trained best_save.pt [flagship]", on_card,
                  card)
    print(f"serving the trained best_save.pt: {len(smis)} SMILES, card "
          f"vs CPU max_abs_err={np.abs(a - b).max():.3e} (tol {TOL})")

    # kernels A and B at the shapes the trainer gives them: a batch of
    # its own loader, padded to the budgets of its largest graphs
    batch = next(iter(trainer.train_loader))
    rng = np.random.RandomState(1)
    csr = batch_csr(batch)
    kern = {w: check_kernel(w, "train_batch", csr, rng, dev, card)
            for w in ("fwd", "bwd")}
    function_on_card_vs_cpu(dev, csr, rng)
    grads_card_vs_cpu(trainer, cfg, batch, dev)
    captured_vs_eager("flagship", trainer, card)
    captured_vs_eager("flagship", trainer, card, optim="SGD")
    captured_vs_eager("flagship", trainer, card, noise=True)
    captured_vs_eager("flagship", trainer, card, optim="Ranger",
                      plan=PLAN_RANGER)
    STEP_TIMES["flagship"] = step_timing(trainer, batch.to(dev), card)
    return {k: launches[k] for k in ("triplet_fused_fwd",
                                     "triplet_fused_bwd")}, kern


def library_phase(dev, card, tmp, demo):
    """TripletMessageLight + Set2Set with BatchNorm and LayerNorm, trained
    through the CLI at full width: kernel C 6 times per forward (3 convs,
    3 Set2Set steps) and per optimizer step, kernels A and B never; one
    step's gradients card vs CPU; kernel C at the trainer's batch; the
    trained checkpoint, running statistics included, serves the whole
    demo corpus on the card as on the CPU, 6 launches per batch."""
    import numpy as np
    import torch
    from glam_tpu_torch.serve import Predictor

    trainer, launches, steps, forwards = run_cli(tmp, LIBRARY_ARGS,
                                                 "light_set2set")
    check_counts("light_set2set training", launches, {
        "segment_softmax_spmm_fwd": 6 * forwards,
        "segment_softmax_spmm_bwd": 6 * steps})
    cfg = trainer.model.cfg
    batch = next(iter(trainer.train_loader))
    grads_card_vs_cpu(trainer, cfg, batch, dev, train_mode=True)
    kern = check_spmm_calls("train", batch, cfg.mol_block, cfg.mol_readout,
                            cfg.hid_dim, np.random.RandomState(2), dev, card)
    captured_vs_eager("light_set2set", trainer, card)
    STEP_TIMES["light_set2set"] = step_timing(trainer, batch.to(dev), card)

    run_dir = trainer.log_save_dir
    on_card = Predictor.from_checkpoint(run_dir, batch_size=128, device=dev)
    on_cpu = Predictor.from_checkpoint(run_dir, batch_size=128,
                                       device="cpu")
    stats = [k for k in on_card.model.state_dict() if k.endswith(".mean")]
    if not stats or any(float(on_card.model.state_dict()[k].abs().max())
                        == 0 for k in stats):
        fail("the trained checkpoint carries no moved running statistics")
    on_card.predict_smiles(demo[:16])                 # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    a = on_card.predict_smiles(demo)
    secs = time.perf_counter() - t0
    served = read_counts()
    b = on_cpu.predict_smiles(demo)
    valid = np.isfinite(b[:, 0])
    n_batches = len(on_card.batches([g for g in on_card.featurize(demo)
                                     if g is not None]))
    check_counts("light_set2set serving", served,
                 {"segment_softmax_spmm_fwd": 6 * n_batches})
    if not (np.isfinite(a[valid]).all() and np.allclose(
            a, b, rtol=TOL, atol=TOL, equal_nan=True)):
        fail(f"trained BatchNorm checkpoint: card and CPU predictions "
             f"differ by {np.nanmax(np.abs(a - b))}")
    replays_bitwise("serving [light_set2set]", on_card, demo, a)
    served_graphs("serving the trained best_save.pt [light_set2set]",
                  on_card, card)
    print(f"serving the trained best_save.pt [light_set2set] "
          f"({len(stats)} BatchNorms' running statistics): {len(demo)} "
          f"SMILES in {n_batches} batches of 128 at budgets nodes="
          f"{on_card.node_budget} edges={on_card.edge_budget}: latency_s="
          f"{secs:.4f}, card vs CPU max_abs_err="
          f"{np.nanmax(np.abs(a - b)):.3e} (tol {TOL}); launches "
          f"segment_softmax_spmm_fwd={served['segment_softmax_spmm_fwd']} "
          f"= 6 x {n_batches} batches, replays included, rows bitwise "
          f"equal to the eager forward's ({card})")
    return launches, served, kern


def gat_phase(dev, card, tmp):
    """GATConv + GlobalLAPool with LayerNorm and GraphSizeNorm, 1 epoch
    through the CLI: kernel C 4 times per forward and per step; one
    step's gradients card vs CPU; kernel C at the trainer's batch (GAT's
    edges and self-loops, GlobalLAPool's graphs at width 2 hid)."""
    import numpy as np
    trainer, launches, steps, forwards = run_cli(tmp, GAT_ARGS,
                                                 "gat_lapool")
    check_counts("gat_lapool training", launches, {
        "segment_softmax_spmm_fwd": 4 * forwards,
        "segment_softmax_spmm_bwd": 4 * steps})
    cfg = trainer.model.cfg
    batch = next(iter(trainer.train_loader))
    grads_card_vs_cpu(trainer, cfg, batch, dev, train_mode=True)
    kern = check_spmm_calls("train", batch, cfg.mol_block, cfg.mol_readout,
                            cfg.hid_dim, np.random.RandomState(3), dev, card)
    return launches, kern


def default_phase(dev, tmp):
    """The CLI with no --mol_block (_NNConv, GlobalPool5, _PairNorm) for 1
    epoch: no kernel launches; then one step of a full-width _GCNConv
    model's gradients card vs CPU on a batch of that trainer."""
    import dataclasses
    import torch
    from glam_tpu_torch.nn.model import Architecture
    torch.cuda.reset_peak_memory_stats()
    trainer, launches, _, _ = run_cli(tmp, ["--epochs", "1"], "default")
    check_counts("default-config training", launches, {})
    cfg = trainer.model.cfg
    print(f"training [default]: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (NNConv's "
          f"per-edge [E, {cfg.hid_dim}, {cfg.hid_dim}] weights at the "
          f"trainer's {next(iter(trainer.train_loader)).num_edges} edge "
          f"slots)")
    if cfg.mol_block != "_NNConv":
        fail(f"the CLI's default conv is {cfg.mol_block}, not _NNConv")
    gcn = dataclasses.replace(cfg, mol_block="_GCNConv")
    grads_card_vs_cpu(trainer, gcn, next(iter(trainer.train_loader)), dev,
                      train_mode=True, state=Architecture(
                          gcn, torch.Generator().manual_seed(0)).state_dict())


def serve_card_vs_cpu(label, run_dir, pairs, dev, contact_maps=None,
                      card=""):
    """``PairPredictor`` on the card and on the CPU from one checkpoint,
    on ``pairs``: the outputs must agree (NaN rows alike).  The card
    serves them twice, the second time through its graph's replays: both
    bitwise equal to its eager forward."""
    import numpy as np
    from glam_tpu_torch.serve import PairPredictor
    on_card = PairPredictor.from_checkpoint(run_dir, device=dev,
                                            contact_maps=contact_maps)
    on_cpu = PairPredictor.from_checkpoint(run_dir, device="cpu",
                                           contact_maps=contact_maps)
    first = on_card.predict_pairs(pairs)
    a, b = on_card.predict_pairs(pairs), on_cpu.predict_pairs(pairs)
    for got in (first, a):
        replays_bitwise(f"serving [{label}]", on_card, pairs, got)
    served_graphs(f"serving the trained best_save.pt [{label}]", on_card,
                  card)
    valid = ~np.isnan(b[:, 0])
    err = float(np.abs(a[valid] - b[valid]).max()) if valid.any() else 0.0
    if not (valid.all() and np.isfinite(a).all()
            and np.allclose(a, b, rtol=TOL, atol=TOL)):
        fail(f"{label}: the trained best_save.pt served on the card and on "
             f"the CPU differ (max_abs_err {err}, {int(valid.sum())} of "
             f"{len(pairs)} pairs resolved)")
    print(f"serving the trained best_save.pt [{label}] with PairPredictor: "
          f"{len(pairs)} pairs, card vs CPU max_abs_err={err:.3e} at outputs "
          f"up to {float(np.abs(b[valid]).max()):.3e} (tol rtol {TOL} + "
          f"atol {TOL})")


def check_triplet_towers(prefix, parts, rng, dev, card, towers=(0, 1)):
    """Kernels A and B at the shapes of each molecule tower's batch in
    ``parts`` (a pair batch); returns {tower: {'fwd': .., 'bwd': ..}}."""
    return {f"mol{t + 1}": {w: check_kernel(
        w, f"{prefix}_mol{t + 1}", batch_csr(parts[t]), rng, dev, card)
        for w in ("fwd", "bwd")} for t in towers}


def gat_calls(prefix, batch, hid, rng, dev, card):
    """Kernel C forward and backward at the shapes of the GAT conv's calls
    on ``batch`` (a protein tower's): every edge slot and a self-loop per
    node, [slots, 1] logits and [slots, hid] values."""
    rowptr, idx = batch.self_loop_csr
    return check_spmm_both(f"{prefix}_gat", spmm_inputs(
        rng, rowptr, idx, batch.num_edges + batch.num_nodes, 1, hid, dev),
        dev, card)


def ddi_phase(dev, card, tmp):
    """DDI through the CLI at full width, 2 epochs: kernels A and B 6
    times per forward and per step (3 message steps x 2 TripletMessage
    towers); the trained checkpoint served on the card as on the CPU;
    kernels A and B at each tower's batch; gradients card vs CPU; step
    time and a profile."""
    import numpy as np
    label = "ddi"
    trainer, launches, steps, forwards = run_cli(
        tmp, DDI_ARGS, label, "drugbank_caster")
    cfg = trainer.model.cfg
    n = 2 * cfg.message_steps
    check_counts("ddi training", launches, {
        "triplet_fused_fwd": n * forwards, "triplet_fused_bwd": n * steps})
    print(f"training [ddi]: launches triplet_fused_fwd="
          f"{launches['triplet_fused_fwd']} = {n} x {forwards} forwards, "
          f"triplet_fused_bwd={launches['triplet_fused_bwd']} = {n} x "
          f"{steps} steps ({card})")
    pairs = [(g1.smi, g2.smi) for g1, g2 in trainer.test_loader.pairs]
    serve_card_vs_cpu("ddi", trainer.log_save_dir, pairs, dev, card=card)
    batch = next(iter(trainer.train_loader))
    kern = check_triplet_towers("ddi", batch, np.random.RandomState(4),
                                dev, card)
    grads_card_vs_cpu(trainer, cfg, batch, dev, train_mode=True)
    captured_vs_eager(label, trainer, card)
    timing = step_timing(trainer, trainer._to_device(batch), card, top=12)
    return launches, kern, timing


def dti_phase(dev, card, tmp):
    """DTI through the CLI at full width with a GATConv protein tower, 1
    epoch: kernel A 3 per forward, B 3 per step, C 3 per forward and 3
    per step; kernel C at the protein tower's batch (against float64),
    A and B at the molecule tower's; the checkpoint served on the card
    as on the CPU; gradients card vs CPU; step time and a profile."""
    import numpy as np
    from glam_tpu_torch.data.pair_datasets import BindingDBDataset
    label = "dti"
    trainer, launches, steps, forwards = run_cli(
        tmp, DTI_ARGS, label, "bindingdb_c")
    cfg = trainer.model.cfg
    n = cfg.message_steps
    check_counts("dti training", launches, {
        "triplet_fused_fwd": n * forwards, "triplet_fused_bwd": n * steps,
        "segment_softmax_spmm_fwd": n * forwards,
        "segment_softmax_spmm_bwd": n * steps})
    print(f"training [dti]: launches {n} x {forwards} forwards and {n} x "
          f"{steps} steps of A/C and B/C-backward: {json.dumps(launches)} "
          f"({card})")
    ds = BindingDBDataset(str(ROOT / "datasets" / PAIR_ROOTS["bindingdb_c"]))
    serve_card_vs_cpu("dti", trainer.log_save_dir,
                      [(g1.smi, g2.smi) for g1, g2 in ds.test], dev,
                      ds.contact_maps, card)
    batch = next(iter(trainer.train_loader))
    rng = np.random.RandomState(5)
    kern = check_triplet_towers("dti", batch, rng, dev, card, towers=(0,))
    kern["gat"] = gat_calls("dti", batch[1], cfg.hid_dim, rng, dev, card)
    grads_card_vs_cpu(trainer, cfg, batch, dev, train_mode=True)
    captured_vs_eager(label, trainer, card)
    timing = step_timing(trainer, trainer._to_device(batch), card, top=12)
    return launches, kern, timing


def synthetic_protein(seed=0, length=1000, contacts=12):
    """A sequence of ``length`` residues and a symmetric contact map with
    about ``contacts`` contacts per residue (|i - j| >= 2, most of them
    within 40 residues) at probabilities in (0.1, 1), drawn from
    ``seed``; the backbone comes from the sequence."""
    import numpy as np
    from glam_tpu_torch.chem.proteins import RES_TYPES
    rng = np.random.RandomState(seed)
    seq = "".join(rng.choice(list(RES_TYPES), length))
    cm = np.zeros((length, length), np.float32)
    for i in range(length):
        for _ in range(contacts // 2):
            j = i + rng.randint(2, 40) if rng.rand() < 0.8 else \
                rng.randint(length)
            if 0 <= j < length and abs(i - j) >= 2:
                p = rng.uniform(0.1, 1.0)
                cm[i, j] = cm[j, i] = max(p, 0.1 + 1e-3)
    return seq, cm


def dti_serving_phase(dev, card, demo):
    """A full-width DTI model (GATConv protein tower) with random weights
    from seed 0, saved and served by PairPredictor at batch 16: 64 demo
    SMILES against a 1,000-residue protein; card vs CPU; kernel C 3 times
    per batch (A too, B and C's backward never), and kernel C at the
    served batch's self-loop CSR; pairs/s and a batch's device ms."""
    import numpy as np
    import torch
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    from glam_tpu_torch.serve import PairPredictor, save_checkpoint

    cfg = ModelConfig(mol_block="_TripletMessage", pro_block="_GATConv",
                      hid_dim_alpha=4, e_dim=1024, message_steps=3,
                      out_dim=2, max_nodes=132, pro_max_nodes=1024)
    model = PairArchitecture(cfg, hetero=True,
                             generator=torch.Generator().manual_seed(0))
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    seq, cm = synthetic_protein()
    maps = {seq: cm}
    smis, atoms = [], {}
    for smi in demo:
        try:
            atoms[smi] = smiles_to_arrays(smi)[0].shape[0]
        except ValueError:
            continue
        smis.append(smi)
        if len(smis) == 64:
            break
    requests = {"demo64_x_protein1000": [(s, seq) for s in smis],
                "with_invalid": [("CCO", seq), ("xyz", seq),
                                 (smis[1], "NOCONTACTMAP"), (smis[2], seq)]}
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, model, {"task": "pair_binary", "num_tasks": 1,
                                     "out_dim": 2})
        pred = PairPredictor.from_checkpoint(tmp, contact_maps=maps,
                                             batch_size=16, device=dev)
        cpu = PairPredictor.from_checkpoint(tmp, contact_maps=maps,
                                            batch_size=16, device="cpu")
    n_contacts = int((cm > 0).sum())
    print(f"dti_serving: full-width DTI model (TripletMessage + GATConv "
          f"towers, hid {cfg.hid_dim}, e_dim {cfg.e_dim}, pro_max_nodes "
          f"{cfg.pro_max_nodes}); protein of {len(seq)} residues, "
          f"{n_contacts} contact-map entries ({n_contacts / len(seq):.1f} "
          f"per residue)")
    # warm-up: the 32 smallest molecules, 2 batches (one eager, one
    # captured), at floors the next request must grow
    pairs64 = requests["demo64_x_protein1000"]
    pred.predict_pairs(sorted(pairs64, key=lambda p: atoms[p[0]])[:32])
    floors, before = (pred.budget1, pred.budget2), dict(pred.graph_stats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = [torch.cuda.memory_reserved(dev)]
    reset_counts()
    outs, secs = {}, {}
    for name, pairs in requests.items():
        t0 = time.perf_counter()
        outs[name] = pred.predict_pairs(pairs)
        secs[name] = time.perf_counter() - t0
    launches = read_counts()
    st = served_graphs("dti_serving", pred, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held.append(torch.cuda.memory_reserved(dev))
    if (before["captures"] != 1 or floors[0] == pred.budget1
            or st["released"] != before["released"] + 1):
        fail(f"dti_serving: the second request's floors {floors} -> "
             f"{(pred.budget1, pred.budget2)} did not grow and free the "
             f"first request's graph (captures {before['captures']}, "
             f"released {before['released']} -> {st['released']})")
    if held[1] - held[0] > st["pool_bytes"]:
        fail(f"dti_serving: device memory held grew by {held[1] - held[0]}"
             f" bytes over a floor growth, more than one pool "
             f"({st['pool_bytes']})")
    print(f"dti_serving: the second request grew the floors {floors} -> "
          f"{(pred.budget1, pred.budget2)}, freeing the first request's "
          f"graph; device memory held {held[0]} -> {held[1]} bytes (one "
          f"pool: {st['pool_bytes']}); its first batch ran eagerly on the "
          "capture's stream, the next captured")
    again = pred.predict_pairs(pairs64)            # replays only
    if not np.array_equal(again, outs["demo64_x_protein1000"],
                          equal_nan=True):
        fail("dti_serving: a request's replays differ from its first "
             "serving (an eager warm-up batch and replays), bitwise")
    n_batches = 0
    for name, pairs in requests.items():
        valid = [s for s in pred.samples(pairs) if s is not None]
        n_batches += len(pred.loader(valid))
        replays_bitwise(f"dti_serving {name}", pred, pairs, outs[name])
        want = cpu.predict_pairs(pairs)
        got = outs[name]
        ok = ~np.isnan(want[:, 0])
        if got.shape != (len(pairs), 2) or not np.allclose(
                got, want, rtol=TOL, atol=TOL, equal_nan=True) or not \
                np.isfinite(got[ok]).all():
            fail(f"dti_serving {name}: card and CPU differ by "
                 f"{np.nanmax(np.abs(got - want))}")
        if name == "with_invalid" and ok.tolist() != [True, False, False,
                                                      True]:
            fail(f"dti_serving: NaN rows {(~ok).tolist()}, not the invalid "
                 "SMILES and the unknown protein")
        print(f"request {name}: {len(pairs)} pairs ({int(ok.sum())} "
              f"resolved) latency_s={secs[name]:.4f} pairs_per_s="
              f"{len(pairs) / secs[name]:.1f} max_abs_err_vs_cpu="
              f"{float(np.abs(got[ok] - want[ok]).max()):.3e} at outputs up "
              f"to {float(np.abs(want[ok]).max()):.3e} (tol rtol {TOL} + "
              f"atol {TOL})")
    check_counts("dti_serving", launches, {
        "triplet_fused_fwd": cfg.message_steps * n_batches,
        "segment_softmax_spmm_fwd": cfg.message_steps * n_batches})
    b1, b2 = next(iter(pred.loader(
        [s for s in pred.samples(requests["demo64_x_protein1000"])])))
    moved = (b1.to(dev), b2.to(dev))
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: pred.model(*moved), reps=10, warmup=2,
                           sleep_cycles=100_000_000)
    request_turns("dti_serving", pred, requests, "pairs", card)
    served_batch_timing("dti_serving", pred, (b1, b2), card, top=12)
    print(f"dti_serving: launches {json.dumps(launches)} = "
          f"{cfg.message_steps} x {n_batches} batches; a batch of 16 pairs: "
          f"protein tower N={b2.num_nodes} E={b2.num_edges} (+{b2.num_nodes} "
          f"self-loops), molecule tower N={b1.num_nodes} E={b1.num_edges}; "
          f"one batch forward device_ms={fwd_ms:.4f} "
          f"({16 / fwd_ms * 1e3:.1f} pairs/s on the device); request "
          f"pairs_per_s={64 / secs['demo64_x_protein1000']:.1f} ({card})")
    rng = np.random.RandomState(6)
    kern = {"gat": gat_calls("serve_dti", b2, cfg.hid_dim, rng, dev, card),
            "mol1": {"fwd": check_kernel("fwd", "serve_dti_mol1",
                                         batch_csr(b1), rng, dev, card)}}
    return launches, kern


def screening_phase(dev, card, tmp):
    """LIT-PCBA ALDH1 through the CLI with its defaults (GCNConv protein
    tower, loss wce), 1 epoch: kernel A 3 per forward, B 3 per step, C
    never; the final line has bedroc; A and B at the molecule tower's
    batch."""
    import numpy as np
    trainer, launches, steps, forwards = run_cli(
        tmp, SCR_ARGS, "screening", "ALDH1")
    cfg = trainer.model.cfg
    n = cfg.message_steps
    check_counts("screening training", launches, {
        "triplet_fused_fwd": n * forwards, "triplet_fused_bwd": n * steps})
    if trainer.args["loss"] != "wce" or cfg.pro_block != "_GCNConv":
        fail(f"screening: loss {trainer.args['loss']}, protein tower "
             f"{cfg.pro_block}; the CLI's defaults are wce and _GCNConv")
    last = (trainer.log_save_dir / "log.txt").read_text().strip() \
        .splitlines()[-1]
    if "bedroc" not in parse_final_line(last)[1]:
        fail(f"screening: the final line has no bedroc: {last!r}")
    kern = check_triplet_towers("screening", next(iter(
        trainer.train_loader)), np.random.RandomState(7), dev, card,
        towers=(0,))
    return launches, kern


# ------------------------------------------------- the parallel layer
DP_RANKS = 2
DP_ARGS = ["--epochs", "1", "--mol_block", "_TripletMessage",
           "--n_devices", str(DP_RANKS), "--batch_size", "64"]
DP_LIBRARY_ARGS = LIBRARY_ARGS[2:] + ["--epochs", "1", "--n_devices",
                                      str(DP_RANKS), "--batch_size", "64"]
HALO_CHANNELS = 60
# the one-step parity's flagship: the CLI's at full width without noise
# (CELU, no dropout), SGD so that the update is linear in the gradient
DP_STEP_ARGS = {"dataset": "demo", "mol_block": "_TripletMessage",
                "hid_dim_alpha": 4, "e_dim": 1024, "message_steps": 3,
                "graph_norm": "_PairNorm", "pre_act": "CELU",
                "graph_act": "CELU", "flat_act": "CELU", "pre_do": "_None()",
                "graph_do": "_None()", "flat_do": "_None()",
                "end_do": "_None()", "task": "binary_nan_bce",
                "loss": "bcel", "num_tasks": 1, "optim": "SGD", "lr": 0.01,
                "batch_size": 64, "seed": 1234}
# the ranks' captured steps against their eager ones: the same flagship
# with SGD and no noise, and with Adam and the CLI's noise (RReLU, the
# flat and end layers' Dropout), whose losses say that each replay draws
# its eager step's masks from the reseeded generator
DP_GRAPH_CONFIGS = {
    "flagship_sgd": DP_STEP_ARGS,
    "flagship_adam_noise": dict(DP_STEP_ARGS, optim="Adam", lr=1e-3,
                                graph_act="RReLU", flat_do="Dropout(0.2)",
                                end_do="Dropout(0.2)")}


def demo_root(tmp):
    root = Path(tmp) / "demo"
    if not root.exists():
        shutil.copytree(DEMO_CSV.parent, root / "raw")
    return root


def run_ranks_cli(tmp, flags, label, dataset="demo", graphs=None,
                  ranks=DP_RANKS):
    """``python -m glam_tpu_torch.run ... --n_devices 2`` (or
    ``--pro_shards 2``) as a user runs it, on the card: the launcher
    starts the gloo ranks, each on cuda:0 (``ranks`` of them; nccl
    ranks, one card each, on a host with as many cards).
    Checks the exit code, that the final line is printed once and parses,
    that every rank replayed step graphs in the design ``graphs`` (None:
    none, eagerly), prints each rank's design and graph stats, and
    returns (run dir, result.json, each rank's launches, optimizer
    steps, forwards a rank, wall s)."""
    if dataset == "demo":
        data = ["--dataset", "demo", "--loss", "bcel", "--dataset_root",
                str(demo_root(tmp))]
    else:
        data = ["--dataset", dataset, "--dataset_root",
                str(ROOT / "datasets" / PAIR_ROOTS[dataset])]
    work = Path(tmp) / label
    argv = data + ["--work_dir", str(work)] + flags
    print(f"training [{label}]: python -m glam_tpu_torch.run "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "glam_tpu_torch.run",
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode:
        print(out[-6000:])
        fail(f"{label}: run with {ranks} ranks exited "
             f"{proc.returncode}")
    for line in out.splitlines():
        if line.startswith(("[distributed]", "[launcher]")):
            print(f"  {line}")
    finals = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("{'testloss'")]
    if len(finals) != 1:
        fail(f"{label}: the final line printed {len(finals)} times")
    runs = [d for d in (work / f"log_{dataset}").iterdir() if d.is_dir()]
    if len(runs) != 1:
        fail(f"{label}: {len(runs)} run directories, expected rank 0's one")
    last = (runs[0] / "log.txt").read_text().strip().splitlines()[-1]
    parse_final_line(last)
    result = json.loads((runs[0] / "result.json").read_text())
    by_rank = result["kernel_launches_by_rank"]
    if len(by_rank) != ranks:
        fail(f"{label}: launches of {len(by_rank)} ranks")
    for k, g in enumerate(result["step_graphs_by_rank"]):
        print(f"training [{label}] rank {k}: step_graphs="
              f"{str(g['step_graphs']).lower()} ({g['reason']}); "
              f"stats {json.dumps(g['stats'])}")
        if (g["step_graphs"] != (graphs is not None) or graphs is not None
                and not g["reason"].startswith(graphs)
                or graphs is not None and not g["stats"]["replays"]):
            fail(f"{label}: rank {k}'s step graphs are not the "
                 f"{graphs or 'eager'} design: {g}")
    if len(result["step_graphs_by_rank"]) != ranks:
        fail(f"{label}: step graphs of "
             f"{len(result['step_graphs_by_rank'])} ranks")
    steps = result["optimizer_steps"]
    if "forwards" in result:            # the sharded trainer counts them
        forwards = result["forwards"]
    else:
        b = result["batches"]
        forwards = steps + result["epochs_trained"] * b["valid"] \
            + b["valid"] + b["test"]
    print(f"training [{label}]: {ranks} ranks, {steps} optimizer steps, "
          f"{forwards} forwards a rank, wall_s={wall:.2f}; launches by "
          f"rank {json.dumps(by_rank)}")
    print(f"final line [{label}]: {last}")
    return runs[0], result, by_rank, steps, forwards, wall


def check_rank_counts(label, by_rank, want):
    for k, counts in enumerate(by_rank):
        check_counts(f"{label} rank {k}", counts, want)


def rank_batch(tmp, args, rank=0):
    """Rank ``rank``'s first sub-batch of the trainer's training loader
    for the demo dataset (``args`` the CLI's, batch 64 over 2 ranks)."""
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import MolDataset
    ds = MolDataset(str(demo_root(tmp)), "demo")
    return next(iter(GraphLoader(ds.train, 64, 1, shuffle=True, seed=1234,
                                 n_devices=DP_RANKS, rank=rank)))


def dp_worker():
    """``tests/torch_port_dp_worker.py``: the rank worker of the port's
    data-parallel and halo checks, which the card test runs too."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_port_dp_worker
    return torch_port_dp_worker


def halo_inputs(ranks=DP_RANKS):
    """The halo phase's graph: the 1,000-residue synthetic protein's
    contact graph, its 49 residue features projected to HALO_CHANNELS by
    a seeded matrix (to unit scale), split over ``ranks`` shards, the v2
    plan, and the step's parameters from seed 0; on the CPU."""
    import numpy as np
    import torch
    from glam_tpu_torch.chem.proteins import protein_to_arrays
    from glam_tpu_torch.parallel import graph_partition as gp
    seq, cm = synthetic_protein()
    nodes, snd, rcv, edges = protein_to_arrays(seq, cm)
    x = nodes @ np.random.RandomState(0).randn(nodes.shape[1],
                                               HALO_CHANNELS)
    x = (x / x.std()).astype(np.float32)             # unit scale
    ns, es, sg, rl, em = gp.split_large_graph(x, edges, snd, rcv, ranks)
    send_idx, _, snd_l, H = gp.build_halo_exchange(sg, em, ns.shape[1])
    params = gp.init_halo_params(torch.Generator().manual_seed(0),
                                 HALO_CHANNELS, edges.shape[1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    shards = {"nodes": ns, "edges": es, "senders_global": sg,
              "receivers": rl, "edge_mask": em, "senders_local": snd_l,
              "send_idx": send_idx}
    return (params, {k: t(v) for k, v in shards.items()},
            tuple(t(a) for a in (x, edges, snd, rcv)), H)


def halo_csr(shards, rank):
    """Kernel C's CSR in the halo step of shard ``rank``: (rowptr, idx,
    entries), the shard's real edges by receiver."""
    import numpy as np
    from glam_tpu_torch.data.graph import receiver_csr
    em = shards["edge_mask"][rank].cpu().numpy()
    rcv = shards["receivers"][rank].cpu().numpy()[em]
    rowptr, _, eid = receiver_csr(np.zeros_like(rcv), rcv,
                                  shards["nodes"].shape[1])
    return rowptr, eid, len(rcv)


def print_dp_times(times, note):
    """Each rank's line of the worker's ``time`` task: the eager step's
    host and busy ms, the gradient all-reduce's, and the step eager and
    replayed in turns with the busy ms (with and without the collectives'
    kernels) and idle share of each (of the busy time without them)."""
    for k, r in enumerate(times):
        print(f"dp step rank {k}: host_ms={r['host_ms']:.4f} busy_ms="
              f"{r['busy']['busy_ms']:.4f} over {r['busy']['kernels']} "
              f"kernels; gradient all_reduce of {r['all_reduce_floats']} "
              f"floats ({r['all_reduce_floats'] * 4 / 1e6:.2f} MB) "
              f"all_reduce_ms={r['all_reduce_ms']:.4f}, medians of 20 "
              f"({note})")
        be, br = r["busy"], r["busy_replayed"]
        ce, cr = (statistics.median(r["turns"][t])
                  for t in ("eager", "replayed"))
        print(f"dp step graphs rank {k} [{r['design']}]: host ms a step in "
              f"turns eager {', '.join(f'{v:.4f}' for v in r['turns']['eager'])}"
              f", replayed {', '.join(f'{v:.4f}' for v in r['turns']['replayed'])}"
              f"; busy ms eager {be['busy_ms']:.4f} over {be['kernels']} "
              f"kernels, replayed {br['busy_ms']:.4f} over {br['kernels']} "
              f"(without collectives' kernels {be['busy_own_ms']:.4f}, "
              f"{br['busy_own_ms']:.4f}); idle share eager "
              f"{1 - be['busy_own_ms'] / ce:.3f}, replayed "
              f"{1 - br['busy_own_ms'] / cr:.3f}; "
              f"{r['graph_stats']['captures']} captures "
              f"{r['graph_stats']['capture_s']:.3f} s, pool "
              f"{r['graph_stats']['pool_bytes'] / 2**20:.1f} MiB ({note})")


def dp_phase(dev, card, tmp):
    """Data parallelism over 2 gloo ranks on the one card: the flagship
    through ``run --n_devices 2`` (A and B per rank exact), the one-step
    parity against one process on the card with each rank's times and
    the gradient all-reduce's, the library model (C both ways per rank)
    and DDI; then the halo steps v1 and v2 (C per rank exact, outputs
    against the plain reference on the card).  Returns each path's
    launches and kernel numbers."""
    import numpy as np
    import torch
    from glam_tpu_torch.parallel.distributed import (backend_for,
                                                     step_graphs_for)
    backend, why = backend_for("cuda", DP_RANKS, torch.cuda.device_count())
    backend_design, design_why = step_graphs_for(backend)
    print(f"dp: {DP_RANKS} ranks on {torch.cuda.device_count()} card(s): "
          f"backend {backend} ({why}); step graphs {backend_design} "
          f"({design_why}); every figure below is from 2 ranks "
          f"time-sliced on one card, not a scaling number ({card})")
    out = {"launches": {}, "kern": {}, "secs": {}}

    t0 = time.perf_counter()
    _, _, by_rank, steps, forwards, _ = run_ranks_cli(tmp, DP_ARGS, "dp",
                                                      graphs=backend_design)
    check_rank_counts("dp", by_rank, {"triplet_fused_fwd": 3 * forwards,
                                      "triplet_fused_bwd": 3 * steps})
    out["launches"]["train_dp"] = by_rank
    rng = np.random.RandomState(11)
    csr = batch_csr(rank_batch(tmp, DP_ARGS))
    out["kern"]["train_dp"] = {w: check_kernel(w, "dp_rank_batch", csr, rng,
                                               dev, card)
                               for w in ("fwd", "bwd")}
    out["secs"]["dp"] = time.perf_counter() - t0

    # the one-step parity, the ranks' times, and the halo steps, by
    # the ranks of the port's data-parallel checks on the card
    from glam_tpu_torch.parallel import graph_partition as gp
    worker = dp_worker()
    t0 = time.perf_counter()
    work = Path(tmp) / "dp_ranks"
    work.mkdir(parents=True)
    params, shards, whole, H = halo_inputs()
    torch.save(dict(shards, params=params), work / "halo.pt")
    (work / "plan.json").write_text(json.dumps({
        "tasks": ["step", "halo", "time", "graphs"],
        "root": str(demo_root(tmp)),
        "configs": {"flagship_demo": DP_STEP_ARGS},
        "graphs": DP_GRAPH_CONFIGS}))
    procs = worker.spawn_ranks(work, "cuda", DP_RANKS)
    single = worker.step_and_eval(worker.trainer(
        "flagship_demo", 1, work, dev, DP_STEP_ARGS, demo_root(tmp)))
    got = worker.wait_ranks(procs, work, timeout=600)
    for k in range(DP_RANKS):
        for line in (work / f"rank{k}.out").read_text().splitlines():
            if line.startswith(("rank ", "profile", "  ", "[distributed]")):
                print(f"  [rank {k}] {line}")
    step, times = got["step_flagship_demo"], got["time"]
    worst = 0.0
    for k, want in single["state"].items():
        scale = max(float(want.abs().max()), 1.0)
        err = float((step["state"][k] - want).abs().max()) / scale
        worst = max(worst, err)
        if not torch.allclose(step["state"][k], want, rtol=TOL,
                              atol=1e-6 * scale):
            fail(f"dp one-step parity: {k} differs by {err:.3e} of its "
                 "scale from one process")
    out_err = float(np.abs(step["out"] - single["out"]).max())
    if not (np.allclose(step["out"], single["out"], rtol=TOL, atol=TOL)
            and math.isclose(step["loss"], single["loss"], rel_tol=TOL)):
        fail(f"dp merged evaluation: outputs differ by {out_err:.3e}, loss "
             f"{step['loss']} against one process's {single['loss']}")
    for k, launches in enumerate(step["launches"]):
        check_counts(f"dp step rank {k}", launches,
                     {"triplet_fused_fwd": 3, "triplet_fused_bwd": 3})
    print(f"dp one-step parity [flagship, SGD, no noise]: {DP_RANKS} gloo "
          f"ranks, each on {dev}, against one process on the card, batch "
          f"64: max error {worst:.3e} of each tensor's scale (tol rtol "
          f"{TOL}, atol 1e-6 x scale); the merged evaluation's outputs "
          f"within {out_err:.3e}, loss {step['loss']:.6f} against "
          f"{single['loss']:.6f} (tol {TOL})")
    print_dp_times(times, f"{DP_RANKS} ranks time-sliced on one card; {card}")
    for name, r in got["graphs"].items():
        runs = r["runs"]
        noise = "noise" in name
        optim = DP_GRAPH_CONFIGS[name]["optim"]
        hold_runs(f"dp {name} rank 0", optim, noise,
                  worker.GRAPH_PLAN, runs, card)
        n = len(runs["captured"][1])
        check_counts(f"dp graphs {name} rank 0", runs["captured"][2],
                     {"triplet_fused_fwd": 3 * n, "triplet_fused_bwd": 3 * n})
        states = r["captured_by_rank"]
        if not all(torch.equal(states[0][k], st[k]) for st in states
                   for k in states[0]):
            fail(f"dp graphs {name}: the ranks' states differ after the "
                 "captured steps")
        print(f"dp graphs [{name}]: after {n} captured steps the "
              f"{DP_RANKS} ranks' {len(states[0])} state tensors "
              f"(parameters, BatchNorm statistics, optimizer state) are "
              f"bitwise equal; launches at replay A {3 * n} = 3 x {n} "
              f"forwards, B {3 * n} = 3 x {n} steps")
    out["secs"]["dp_step"] = time.perf_counter() - t0

    # the halo steps
    for k, launches in enumerate(got["halo"]["launches"]):
        check_counts(f"halo rank {k}", launches,
                     {"segment_softmax_spmm_fwd": 2})
    ref = gp.reference_halo_step({k: v.to(dev) for k, v in params.items()},
                                 *(a.to(dev) for a in whole)).cpu()
    N = ref.shape[0]
    err, close = [], True
    for v in ("v1", "v2"):
        g = got["halo"][v].reshape(-1, HALO_CHANNELS)[:N]
        err.append(float((g - ref).abs().max()))
        close = close and torch.allclose(g, ref, rtol=1e-5, atol=1e-5)
    if not close:
        fail(f"halo steps against reference_halo_step: v1 {err[0]:.3e}, "
             f"v2 {err[1]:.3e} (tol rtol 1e-5 + atol 1e-5; largest entry "
             f"{float(ref.abs().max()):.3e})")
    n_local = shards["nodes"].shape[1]
    b1, b2 = gp.halo_bytes(n_local, H, HALO_CHANNELS, DP_RANKS)
    print(f"halo [synthetic protein, 1,000 residues, {DP_RANKS} shards of "
          f"{n_local} rows, C={HALO_CHANNELS}, halo budget H={H}]: v1 "
          f"(all_gather) max_abs_err={err[0]:.3e}, v2 (all_to_all) "
          f"{err[1]:.3e} against the plain reference on the card (tol rtol "
          f"1e-5 + atol 1e-5; largest entry {float(ref.abs().max()):.3e}); "
          f"features received a rank a step: v1 {b1} bytes, v2 {b2} bytes; "
          f"step ms by rank "
          f"{[[round(x, 4) for x in r['halo_ms']] for r in times]} "
          f"(v1, v2, medians of 20; gloo ranks on one card; {card})")
    out["launches"]["halo"] = got["halo"]["launches"]
    rowptr, idx, m = halo_csr(shards, 0)
    out["kern"]["halo"] = check_spmm_both(
        "halo_shard0", spmm_inputs(np.random.RandomState(12), rowptr, idx, m,
                                   1, HALO_CHANNELS, dev), dev, card)

    t0 = time.perf_counter()
    _, _, by_rank, steps, forwards, _ = run_ranks_cli(
        tmp, DP_LIBRARY_ARGS, "dp_library", graphs=backend_design)
    check_rank_counts("dp_library", by_rank, {
        "segment_softmax_spmm_fwd": 6 * forwards,
        "segment_softmax_spmm_bwd": 6 * steps})
    out["launches"]["train_dp_library"] = by_rank
    out["kern"]["train_dp_library"] = check_spmm_calls(
        "dp_rank", rank_batch(tmp, DP_LIBRARY_ARGS), "_TripletMessageLight",
        "Set2Set", 60, np.random.RandomState(13), dev, card)
    out["secs"]["dp_library"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, _, by_rank, steps, forwards, _ = run_ranks_cli(
        tmp, DP_ARGS, "dp_pair", "drugbank_caster", graphs=backend_design)
    check_rank_counts("dp_pair", by_rank, {"triplet_fused_fwd": 6 * forwards,
                                           "triplet_fused_bwd": 6 * steps})
    out["launches"]["train_dp_ddi"] = by_rank
    from glam_tpu_torch.data.batching import PairGraphLoader
    from glam_tpu_torch.data.pair_datasets import DDIDataset
    ds = DDIDataset(str(ROOT / "datasets" / PAIR_ROOTS["drugbank_caster"]))
    pair = next(iter(PairGraphLoader(ds.train, 64, 1, shuffle=True,
                                     seed=1234, n_devices=DP_RANKS, rank=0)))
    out["kern"]["train_dp_ddi"] = check_triplet_towers(
        "dp_ddi", pair, np.random.RandomState(14), dev, card)
    out["secs"]["dp_pair"] = time.perf_counter() - t0
    return out


SHARDED_ARGS = ["--epochs", "1", "--mol_block", "_TripletMessage",
                "--pro_block", "_GATConv", "--pro_shards", str(DP_RANKS)]
SHARDED_RING_ARGS = SHARDED_ARGS + ["--halo", "ring", "--pair_batch", "4"]
# the 1,000-residue step: the CLI's full-width model (hid 60, 3 steps,
# e_dim 1024, GlobalPool5 readouts) in evaluation mode, weights from
# seed 0
SHARDED_PROTEIN_TOWERS = ("_GATConv", "_TripletMessage")


def giant_demo():
    """``scripts/giant_protein_demo_torch.py`` as a module (its seeded
    generator, its trainer's arguments)."""
    import importlib.util
    path = ROOT / "scripts" / "giant_protein_demo_torch.py"
    spec = importlib.util.spec_from_file_location("giant_protein_demo_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sharded_protein_cases(length=1000, hid_alpha=4, e_dim=1024, time=True,
                          giant=False, overlap_ab=False):
    """The worker's ``sharded.pt`` cases of the 1,000-residue synthetic
    protein (``giant``: the giant demo's generator's protein of
    ``length`` residues from seed 0) paired with a demo molecule, one a
    protein tower: a2a and ring, one Adam step (the ranks' parameters),
    and on the card their times (``time``) and the overlap's A/B
    (``overlap_ab``); with each case's dense reference inputs."""
    import dataclasses

    import numpy as np
    import torch
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.chem.proteins import protein_to_arrays
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    if giant:
        g = giant_demo().synth_protein(length, 0)
        nodes, snd, rcv, edges = g.nodes, g.senders, g.receivers, g.edges
    else:
        seq, cm = synthetic_protein(length=length)
        nodes, snd, rcv, edges = protein_to_arrays(seq, cm)
    smi = "CC(=O)Oc1ccccc1C(=O)O"
    x, s, r, e = smiles_to_arrays(smi)
    mol = (x, e, s, r, np.zeros(1, np.float32), smi)
    cases = {}
    for pro in SHARDED_PROTEIN_TOWERS:
        cfg = ModelConfig(mol_block="_TripletMessage", pro_block=pro,
                          pro_in_dim=nodes.shape[1],
                          pro_edge_in_dim=edges.shape[1],
                          hid_dim_alpha=hid_alpha, e_dim=e_dim, out_dim=2,
                          max_nodes=64, pro_max_nodes=max(1024, length))
        model = PairArchitecture(cfg, hetero=True,
                                 generator=torch.Generator().manual_seed(0))
        cases[f"{'giant' if giant else 'protein'}{length}{pro}"] = dict(
            kind="pair", cfg=dataclasses.asdict(cfg),
            state=model.state_dict(), graphs=[(nodes, edges, snd, rcv)],
            mols=[mol], ring=True, adam=True, time=time,
            overlap_ab=overlap_ab)
    return cases


def dense_pair_reference(case, dev):
    """The dense PairArchitecture of a ``sharded.pt`` case on ``dev`` in
    evaluation mode: its output on the case's first pair and the
    gradients of the worker's loss (mean squared error to 0.3)."""
    import numpy as np
    import torch
    from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    model = PairArchitecture(ModelConfig(**case["cfg"]), hetero=True)
    model.load_state_dict(case["state"])
    model = model.to(dev).eval()
    pro = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    g1 = pad_graphs([GraphArrays(*case["mols"][0])], 1, 64, 128,
                    num_tasks=1).to(dev)
    n = 8 * -(-(pro.nodes.shape[0] + 1) // 8)
    g2 = pad_graphs([pro], 1, n, 8 * -(-pro.senders.shape[0] // 8) + 8,
                    num_tasks=1).to(dev)
    out = model(g1, g2)[:1]
    ((out - 0.3) ** 2).mean().backward()
    return out.detach().cpu(), {k: p.grad.detach().cpu()
                                for k, p in model.named_parameters()
                                if p.grad is not None}


def hold_sharded(label, got, out, grads):
    """Fail unless the sharded output is within rtol/atol 1e-4 of the
    dense one and every gradient within rtol 2e-4 + atol 5e-5 x its
    leaf's scale; returns the worst (output error, gradient error of its
    scale)."""
    import torch
    if not torch.allclose(got["out"], out, rtol=TOL, atol=TOL):
        fail(f"{label}: sharded output differs from dense by "
             f"{float((got['out'] - out).abs().max()):.3e}")
    worst = 0.0
    for k, want in grads.items():
        scale = max(float(want.abs().max()), 1.0)
        err = float((got["grads"][k] - want).abs().max()) / scale
        worst = max(worst, err)
        if not torch.allclose(got["grads"][k], want, rtol=2e-4,
                              atol=5e-5 * scale):
            fail(f"{label}: gradient {k} differs from dense by {err:.3e} "
                 "of its scale")
    return float((got["out"] - out).abs().max()), worst


def shard_kernel_inputs(case, rank=0):
    """Rank ``rank``'s packed shard (2 shards, a2a) of a case's protein,
    on the CPU."""
    import numpy as np
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.parallel import sharded_model as sm
    g = GraphArrays(*case["graphs"][0], y=np.zeros(1, np.float32))
    return sm.pack_shards([sm.shard_at(g, DP_RANKS, rank, sm.corpus_budgets(
        [g], DP_RANKS))], DP_RANKS)


def sharded_phase(dev, card, tmp):
    """The node-sharded protein tower over 2 gloo ranks on the one card:
    ``sharded_dti`` and ``sharded_ring`` through ``run --pro_shards 2``
    (launches of A, B, C and C's backward exact on each rank, the final
    line once, the checkpoint served on the card as on the CPU), then
    ``sharded_protein``: the 1,000-residue protein's sharded pair forward
    and gradients against the dense model on the card (GAT and
    TripletMessage towers, a2a and ring), one Adam step leaving the ranks
    equal, each rank's step, halo and collective times, the overlap on
    and off in turns (:func:`hold_overlap`); kernels at the shards'
    shapes; the giant demo at L = 3,000 (:func:`giant_protein_run`);
    ``bench_scaling --analytic``."""
    import numpy as np
    import torch
    from glam_tpu_torch.data.graph import pad_graphs
    from glam_tpu_torch.data.pair_datasets import BindingDBDataset
    from glam_tpu_torch.parallel import sharded_model as sm
    from glam_tpu_torch.parallel.distributed import (
        backend_for, sharded_step_graphs_for)
    out = {"launches": {}, "kern": {}}
    backend = backend_for("cuda", DP_RANKS, torch.cuda.device_count())[0]
    design, why = sharded_step_graphs_for(backend)
    if design is not None:
        fail(f"sharded: {DP_RANKS} ranks on {torch.cuda.device_count()} "
             f"card(s) under {backend} would replay graphs ({why})")
    print(f"sharded: {DP_RANKS} {backend} ranks on one card; step graphs: "
          f"none, the sharded steps run eagerly under {backend} ({why}); "
          f"every figure below is from ranks time-sliced on one card, not "
          f"a scaling number ({card})")
    ds = BindingDBDataset(str(ROOT / "datasets" / PAIR_ROOTS["bindingdb_c"]))
    test_pairs = [(g1.smi, g2.smi) for g1, g2 in ds.test]
    rng = np.random.RandomState(21)
    for label, flags, path, B in (
            ("sharded_dti", SHARDED_ARGS, "train_sharded_dti", 1),
            ("sharded_ring", SHARDED_RING_ARGS, "train_sharded_ring", 4)):
        t0 = time.perf_counter()
        run_dir, result, by_rank, steps, forwards, _ = run_ranks_cli(
            tmp, flags, label, "bindingdb_c")
        check_rank_counts(label, by_rank, {
            "triplet_fused_fwd": 3 * forwards,
            "triplet_fused_bwd": 3 * steps,
            "segment_softmax_spmm_fwd": 3 * forwards,
            "segment_softmax_spmm_bwd": 3 * steps})
        print(f"training [{label}]: launches exact on each rank: A and C "
              f"3 x {forwards} forwards, B and C's backward 3 x {steps} "
              f"steps")
        serve_card_vs_cpu(label, run_dir, test_pairs, dev, ds.contact_maps,
                          card)
        out["launches"][path] = by_rank
        # the kernels at this path's shapes: A and B at a step's molecule
        # batch, C at rank 0's GAT shard of the first training protein
        # (the trainer's first B pairs, its corpus budgets, rank 0)
        pairs = ds.train[:B]
        mol_b = pad_graphs([p[0] for p in pairs], B, B * 64, B * 128,
                           num_tasks=1)
        budgets = sm.corpus_budgets(
            [p[1] for p in ds.train + ds.val + ds.test], DP_RANKS,
            "ring" if "ring" in flags else "a2a")
        shard = sm.pack_shards([sm.shard_at(p[1], DP_RANKS, 0, budgets)
                                for p in pairs], DP_RANKS)
        kern = {w: check_kernel(w, f"{label}_mol_batch", batch_csr(mol_b),
                                rng, dev, card) for w in ("fwd", "bwd")}
        kern["gat"] = check_spmm_both(f"{label}_gat_shard0", spmm_inputs(
            rng, shard.loop_rowptr.numpy(), shard.loop_idx.numpy(),
            shard.edges.shape[0] + B * shard.n_local, 1, 60, dev), dev,
            card)
        out["kern"][path] = kern
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    worker = dp_worker()
    work = Path(tmp) / "sharded_ranks"
    work.mkdir(parents=True)
    cases = sharded_protein_cases(overlap_ab=True)
    torch.save(cases, work / "sharded.pt")
    (work / "plan.json").write_text(json.dumps({
        "tasks": ["sharded", "sharded_time", "sharded_overlap"],
        "dump_after": 540}))
    procs = worker.spawn_ranks(work, "cuda", DP_RANKS)
    dense = {name: dense_pair_reference(case, dev)
             for name, case in cases.items()}
    got = worker.wait_ranks(procs, work, timeout=600)
    for k in range(DP_RANKS):
        for line in (work / f"rank{k}.out").read_text().splitlines():
            if line.startswith(("profile", "[distributed]")):
                print(f"  [rank {k}] {line}")
    launches = [{} for _ in range(DP_RANKS)]
    for name in cases:
        for halo in ("a2a", "ring"):
            r = got["sharded"][name][halo]
            out_err, grad_err = hold_sharded(f"sharded_protein {name} {halo}",
                                             r, *dense[name])
            print(f"sharded_protein [{name} {halo}]: 1,000-residue protein "
                  f"over {DP_RANKS} shards, full width; output within "
                  f"{out_err:.3e} of the dense model on the card at outputs "
                  f"up to {float(dense[name][0].abs().max()):.3e} (tol rtol "
                  f"{TOL} + atol {TOL}), gradients within {grad_err:.3e} of "
                  f"each leaf's scale (tol rtol 2e-4 + atol 5e-5 x scale)")
        states = got["sharded"][name]["adam"]
        if not all(torch.equal(states[0][k], states[1][k])
                   for k in states[0]):
            fail(f"sharded_protein {name}: the ranks' parameters differ "
                 "after one Adam step")
        print(f"sharded_protein [{name}]: after one Adam step both ranks' "
              f"{len(states[0])} tensors are bitwise equal")
        # one forward and backward of the two towers, 3 message steps
        a = 6 if name.endswith("_TripletMessage") else 3
        c = 3 if name.endswith("_GATConv") else 0
        for k, counts in enumerate(got["sharded"][name]["launches"]):
            check_counts(f"sharded_protein {name} rank {k}", counts, {
                "triplet_fused_fwd": a, "triplet_fused_bwd": a,
                "segment_softmax_spmm_fwd": c,
                "segment_softmax_spmm_bwd": c})
            for n, v in counts.items():
                launches[k][n] = launches[k].get(n, 0) + v
    for k, r in enumerate(got["sharded_time"]):
        for key, t in r.items():
            print(f"sharded step rank {k} [{key}]: host_ms="
                  f"{t['host_ms']:.4f} busy_ms={t['busy']['busy_ms']:.4f} "
                  f"over {t['busy']['kernels']} kernels; halo exchange of "
                  f"{t['halo_rows']} rows = {t['halo_bytes']} bytes "
                  f"received a message step (x3 steps, x2 with the "
                  f"backward) halo_ms={t['halo_ms']:.4f}; the gradient's "
                  f"extra collectives: all_reduce of "
                  f"{t['grad_all_reduce_floats']} floats "
                  f"{t['grad_all_reduce_ms']:.4f} ms, broadcast of "
                  f"{t['grad_broadcast_floats']} floats "
                  f"{t['grad_broadcast_ms']:.4f} ms; medians (2 gloo ranks "
                  f"time-sliced on one card, not a scaling number; {card})")
    hold_overlap(got["sharded_overlap"], f"{DP_RANKS} gloo ranks "
                 f"time-sliced on one card; {card}")
    # each rank's a2a forward and backward of each tower
    out["launches"]["sharded_protein"] = launches
    gat, triplet = (f"protein1000{t}" for t in SHARDED_PROTEIN_TOWERS)
    shard = shard_kernel_inputs(cases[triplet])
    csr = (shard.csr_rowptr.numpy(), shard.csr_snd.numpy(),
           shard.csr_eid.numpy(), shard.edges.numpy())
    kern = {w: check_kernel(w, "protein1000_table_shard0", csr, rng, dev,
                            card) for w in ("fwd", "bwd")}
    gshard = shard_kernel_inputs(cases[gat])
    kern["gat"] = check_spmm_both("protein1000_gat_shard0", spmm_inputs(
        rng, gshard.loop_rowptr.numpy(), gshard.loop_idx.numpy(),
        gshard.edges.shape[0] + gshard.n_local, 1, 60, dev), dev, card)
    out["kern"]["sharded_protein"] = kern
    print(f"phase sharded_protein: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["launches"]["giant_protein"], out["kern"]["giant_protein"] = \
        giant_protein_run(tmp, rng, dev, card)
    print(f"phase giant_protein: {time.perf_counter() - t0:.2f} s")
    res = subprocess.run([sys.executable, "-m",
                          "glam_tpu_torch.parallel.bench_scaling",
                          "--analytic"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if res.returncode:
        print(res.stdout[-3000:] + res.stderr[-3000:])
        fail("bench_scaling --analytic failed")
    for line in res.stdout.strip().splitlines():
        print(f"bench_scaling --analytic: {line}")
    return out


def hold_overlap(runs_by_case, note):
    """The worker's ``sharded_overlap`` runs (``GLAM_SHARDED_OVERLAP`` 1,
    0, 0, 1 of each case and plan): fail unless the no-grad outputs are
    bitwise equal, the launches equal, and each gradient of an overlapped
    run within twice the spread of the runs of one setting (plus 1e-6 of
    its scale) of the run beside it without the overlap; print the eager
    step's ms in turns."""
    import torch
    for key, runs in runs_by_case.items():
        first = runs[0]
        for r in runs[1:]:
            if not torch.equal(r["out"], first["out"]):
                fail(f"overlap [{key}]: the output with "
                     f"GLAM_SHARDED_OVERLAP={r['flag']} differs from "
                     f"{first['flag']}'s by "
                     f"{float((r['out'] - first['out']).abs().max()):.3e}")
            if r["launches"] != first["launches"]:
                fail(f"overlap [{key}]: launches {r['launches']} against "
                     f"{first['launches']}")
        worst, widest = 0.0, 0.0
        for k, g in first["grads"].items():
            gs = [r["grads"][k] for r in runs]
            scale = max(float(gs[0].abs().max()), 1.0)
            spread = max(float((gs[0] - gs[3]).abs().max()),
                         float((gs[1] - gs[2]).abs().max()))
            err = max(float((gs[0] - gs[1]).abs().max()),
                      float((gs[3] - gs[2]).abs().max()))
            worst, widest = max(worst, err / scale), max(widest,
                                                         spread / scale)
            if err > 2 * spread + 1e-6 * scale:
                fail(f"overlap [{key}]: gradient {k} on and off differ by "
                     f"{err:.3e}, beyond twice the runs' spread {spread:.3e}"
                     f" + 1e-6 x its scale {scale:.3e}")
        turns = ", ".join(f"{r['flag']}: {r['step_ms']:.4f}" for r in runs)
        print(f"overlap [{key}]: GLAM_SHARDED_OVERLAP 1, 0, 0, 1 eagerly: "
              f"outputs bitwise equal, launches equal "
              f"{json.dumps(first['launches'])}; gradients on against off "
              f"within {worst:.3e} of each leaf's scale (the runs of one "
              f"setting {widest:.3e} apart); an Adam step's host ms in "
              f"turns {turns} ({note})")


def giant_protein_run(tmp, rng, dev, card):
    """``scripts/giant_protein_demo_torch.py --shards 2 --L 3000 --epochs
    1`` as a user runs it, on the card (2 gloo ranks on cuda:0): exit 0,
    the plan line, launches exact on each rank (A 3 a forward and B 3 a
    step, the molecule tower's; the GCN protein tower runs none); then
    kernels A and B at a step's molecule batch (its pair batch of 2).
    Returns (each rank's launches, the kernels' numbers)."""
    import numpy as np
    from glam_tpu_torch.data.graph import pad_graphs
    argv = ["--shards", str(DP_RANKS), "--L", "3000", "--epochs", "1",
            "--work_dir", str(Path(tmp) / "giant_protein")]
    print(f"giant_protein: python scripts/giant_protein_demo_torch.py "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "giant_protein_demo_torch.py"),
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        print((proc.stdout + proc.stderr)[-6000:])
        fail(f"giant_protein: exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith(("corpus:", "plan:", "halo:", "trained",
                            "step rank", "[distributed]")):
            print(f"giant_protein: {line}")
    if not any(line.startswith("plan: node_budget") for line in lines):
        fail("giant_protein: no plan line")
    got = json.loads(lines[-1])
    by_rank = []
    for k, r in enumerate(got["launches_by_rank"]):
        r = dict(r)
        steps, forwards = r.pop("steps"), r.pop("forwards")
        check_counts(f"giant_protein rank {k}", r, {
            "triplet_fused_fwd": 3 * forwards,
            "triplet_fused_bwd": 3 * steps})
        by_rank.append(r)
    print(f"giant_protein: L=3000 over {DP_RANKS} ranks, {steps} steps and "
          f"{forwards} forwards a rank, launches exact on each rank (A 3 x "
          f"forwards, B 3 x steps) {json.dumps(by_rank)}; val_loss="
          f"{got['val_loss']:.4f} val_auc={got['val_auc']}; wall_s="
          f"{wall:.2f} ({card})")
    if not np.isfinite(got["val_loss"]):
        fail("giant_protein: the validation loss is not finite")
    demo = giant_demo()
    mols = [demo.synth_mol(i, 0.0) for i in range(2)]
    every = [demo.synth_mol(i, 0.0) for i in range(got["pairs"])]
    nb = 8 * -(-max(m.nodes.shape[0] for m in every) // 8) + 8
    eb = 8 * -(-max(m.senders.shape[0] for m in every) // 8) + 8
    mol_b = pad_graphs(mols, 2, 2 * nb, 2 * eb, num_tasks=1)
    kern = {w: check_kernel(w, "giant_mol_batch", batch_csr(mol_b), rng, dev,
                            card) for w in ("fwd", "bwd")}
    return by_rank, kern


def cuda_context_check():
    """In a fresh process: ``DeviceManager``'s card count
    (``torch.cuda.device_count()``) leaves every card's primary context
    inactive, as ``cuDevicePrimaryCtxGetState`` reports it (the solver
    process creates no context before it blends)."""
    code = """if True:
        import ctypes, json, torch
        from glam_tpu_torch.automl.scheduler import DeviceManager
        dm = DeviceManager()
        cuda = ctypes.CDLL("libcuda.so.1")
        def call(fn, *args):
            if fn(*args) != 0:
                raise RuntimeError(f"{fn.__name__} failed")
        call(cuda.cuInit, 0)
        active = []
        for i in range(dm.num_cards):
            dev, flags, on = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
            call(cuda.cuDeviceGet, ctypes.byref(dev), i)
            call(cuda.cuDevicePrimaryCtxGetState, dev, ctypes.byref(flags),
                 ctypes.byref(on))
            active.append(on.value)
        print(json.dumps({"cards": dm.num_cards, "slots": dm.num_slots,
                          "torch_initialized": torch.cuda.is_initialized(),
                          "primary_contexts_active": active}))
    """
    env = dict(os.environ)
    env.pop("GLAM_TPU_TRIAL_SLOTS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"the CUDA context check failed:\n{proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"automl: DeviceManager in a fresh process: {json.dumps(got)}")
    if got["cards"] < 1 or got["torch_initialized"] or any(
            got["primary_contexts_active"]):
        fail("counting the cards created a CUDA context (or found none)")


def automl_configs():
    """The solver's first configurations at AUTOML_SEED, drawn as
    ``GLAM.low_fidelity_training`` draws them (ids not repeated; an id
    hashes the dataset root too, so the solver's ids differ)."""
    from glam_tpu_torch.automl.search_space import sample_config
    rng, seen, out = random.Random(AUTOML_SEED), [], []
    for _ in range(AUTOML_ARGS["n_init_configs"]):
        cfg, cid = sample_config("physprop_perturb", "", AUTOML_SEED, 1234,
                                 rng)
        while cid in seen:
            cfg, cid = sample_config("physprop_perturb", "", AUTOML_SEED,
                                     1234, rng)
        seen.append(cid)
        out.append(dict(cfg, note=cid))
    return out


def config_calls(cfg, mol_in_dim=15):
    """The kernel calls of one forward of a single-graph config: [(kind,
    H, C, calls per forward)], kind 'triplet' (kernel A, and B per step),
    'light', 'gat' (kernel C over the conv's edges), 'set2set' or
    'lapool' (kernel C over the graphs)."""
    hid, steps = mol_in_dim * int(cfg["hid_dim_alpha"]), int(
        cfg["message_steps"])
    calls = []
    conv = {"_TripletMessage": ("triplet", 3), "_TripletMessageLight":
            ("light", 1), "_GATConv": ("gat", 1)}.get(cfg["mol_block"])
    if conv:
        calls.append((conv[0], conv[1], hid, steps))
    if cfg["mol_readout"] == "Set2Set":
        calls.append(("set2set", 1, hid, 3))
    elif cfg["mol_readout"] == "GlobalLAPool":
        calls.append(("lapool", 1, 2 * hid, 1))
    return calls


def per_forward(cfg):
    """{kernel: launches per forward} of a config; a training step runs
    the same counts of kernels B and C's backward."""
    a = sum(n for kind, _, _, n in config_calls(cfg) if kind == "triplet")
    c = sum(n for kind, _, _, n in config_calls(cfg) if kind != "triplet")
    return {"triplet_fused_fwd": a, "segment_softmax_spmm_fwd": c}


def spmm_call_inputs(kind, batch, C, rng, dev):
    """Kernel C's arguments at the shapes of a ``kind`` call on
    ``batch``: logits [M, 1] and values [M, C] around its CSR."""
    from glam_tpu_torch.data.graph import graph_csr
    if kind == "light":
        (rowptr, idx), m = batch.padded_csr, batch.num_edges
    elif kind == "gat":
        (rowptr, idx), m = batch.self_loop_csr, batch.num_edges + \
            batch.num_nodes
    else:
        (rowptr, idx), m = graph_csr(batch.n_node, batch.num_nodes), \
            batch.num_nodes
    return spmm_inputs(rng, rowptr, idx, m, 1, C, dev)


def automl_width_checks(dev, card, demo, ds):
    """Kernels A and B at (H, C) = (3, 15) and (3, 90), and C both ways
    at (1, 15), (1, 90) over a TripletMessageLight conv's edge slots and
    at (1, 180) over GlobalLAPool's graphs (hid 90), on a 768-molecule
    physprop_perturb batch (the search's largest, at a trainer's budgets)
    and on the 128-molecule demo batch: the widths the search draws, on
    the kernels' one-lane path.  Returns {kernel: [numbers]} (off every
    path: their errors count, their times go to PERF.md)."""
    import numpy as np
    from glam_tpu_torch.data.batching import GraphLoader
    rng = np.random.RandomState(8)
    out = {f"{k}_{w}": [] for k in ("triplet_fused", "segment_softmax_spmm")
           for w in ("fwd", "bwd")}
    for bname, batch in (("physprop768", next(iter(GraphLoader(
            ds.train, 768, 1)))), ("demo128", demo_batch(demo))):
        for C in AUTOML_TRIPLET_WIDTHS:
            for w in ("fwd", "bwd"):
                out[f"triplet_fused_{w}"].append(check_kernel(
                    w, f"{bname}_h3_c{C}", batch_csr(batch), rng, dev,
                    card, 3, C))
        for C in AUTOML_SPMM_WIDTHS:
            kind = "lapool" if C == 180 else "light"
            r = check_spmm_both(f"{bname}_{kind}_h1_c{C}", spmm_call_inputs(
                kind, batch, C, rng, dev), dev, card)
            for w in ("fwd", "bwd"):
                out[f"segment_softmax_spmm_{w}"].append(r[w])
    return out


class UtilSampler:
    """The card's utilisation and memory, from ``nvidia-smi`` about every
    ``period`` seconds in a thread, while it runs (a ``with`` block)."""

    def __init__(self, period=0.5):
        self.period, self.samples = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t = time.time()
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu,memory.used",
                 "--format=csv,noheader,nounits", "--id=0"],
                capture_output=True, text=True, timeout=30)
            if r.returncode == 0:
                util, mem = (float(v) for v in r.stdout.split(","))
                self.samples.append((t, util, mem))
            self._stop.wait(max(0.0, self.period - (time.time() - t)))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            fail("the nvidia-smi sampler did not stop")

    def summary(self, t0=None, t1=None):
        s = [(u, m) for t, u, m in self.samples
             if (t0 is None or t >= t0) and (t1 is None or t <= t1)]
        if not s:
            fail("no nvidia-smi utilisation sample")
        utils = [u for u, _ in s]
        return (f"utilisation mean {statistics.mean(utils):.1f}% median "
                f"{statistics.median(utils):.1f}% max {max(utils):.0f}%, "
                f"{sum(u > 0 for u in utils) / len(utils):.3f} of "
                f"{len(utils)} samples busy; memory used up to "
                f"{max(m for _, m in s):.0f} MiB")


def run_search(tmp, slots, label, full):
    """The solver on a fresh copy of physprop_perturb with
    GLAM_TPU_TRIAL_SLOTS=slots on the one card: ``glam.main`` (low
    fidelity, high fidelity, blend and PASP) when ``full``, else the
    low-fidelity phase alone; the card sampled throughout; the trials'
    output in a file.  Returns (solver, {'wall_s', 'low_s', 'util',
    'util_low', 'launches'}): launches are this process's over the run
    (the blend and PASP; the trials are other processes)."""
    from glam_tpu_torch import glam
    from glam_tpu_torch.automl.solver import GLAM
    root = Path(tmp) / f"physprop_{label}"
    shutil.copytree(PHYSPROP_CSV.parent, root / "raw")
    work = Path(tmp) / f"automl_{label}"
    work.mkdir()
    os.environ["GLAM_TPU_TRIAL_SLOTS"] = str(slots)
    out_path = work / "trials_stdout.txt"
    print(f"automl search [{label}]: GLAM_TPU_TRIAL_SLOTS={slots}, seed "
          f"{AUTOML_SEED}, {json.dumps(AUTOML_ARGS)}"
          f"{'' if full else ' (low-fidelity phase only)'}; the trials' "
          f"output goes to {out_path.name}", flush=True)
    reset_counts()
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(out_path, "w") as out, UtilSampler() as sampler:
            os.dup2(out.fileno(), 1)
            t0 = time.time()
            if full:
                argv = ["--dataset", "physprop_perturb", "--dataset_root",
                        str(root), "--seed", str(AUTOML_SEED),
                        "--work_dir", str(work)]
                for k, v in AUTOML_ARGS.items():
                    argv += [f"--{k}", str(v)]
                solver = glam.main(argv)
            else:
                solver = GLAM("physprop_perturb", str(root),
                              seed=AUTOML_SEED, work_dir=str(work),
                              **{k: v for k, v in AUTOML_ARGS.items()
                                 if k in ("n_init_configs",
                                          "n_low_fidelity_seed",
                                          "low_fidelity_epochs")})
                solver.low_fidelity_training()
            import torch
            torch.cuda.synchronize()
            wall = time.time() - t0
            sys.stdout.flush()
    except BaseException:
        os.dup2(saved, 1)
        print(f"automl search [{label}] failed; the end of its output:\n"
              f"{out_path.read_text()[-6000:]}")
        raise
    finally:
        os.dup2(saved, 1)
        os.close(saved)
    launches = read_counts()
    n_low = AUTOML_ARGS["n_init_configs"] * AUTOML_ARGS["n_low_fidelity_seed"]
    low = solver.trials[:n_low]
    low_end = max(t["start"] + t["seconds"] for t in low)
    return solver, {"wall_s": wall, "low_s": low_end - t0,
                    "util": sampler.summary(),
                    "util_low": sampler.summary(t0, low_end),
                    "launches": launches}


def trial_run_dir(solver, trial):
    """The run directory of a launched trial: the one whose result.json
    config agrees with the trial's on every key the trial set."""
    keys = ("note", "seed", "epochs", "mol_block", "mol_readout",
            "hid_dim_alpha", "message_steps", "batch_size", "e_dim", "lr",
            "optim", "loss")
    found = []
    for d in sorted(solver.logs_dir.iterdir()):
        res = d / "result.json"
        if res.is_file():
            cfg = json.loads(res.read_text())["config"]
            if all(cfg.get(k) == trial["config"].get(k) for k in keys):
                found.append((d, json.loads(res.read_text())))
    if len(found) != 1:
        fail(f"trial {trial['config'].get('note')} seed "
             f"{trial['config'].get('seed')}: {len(found)} run directories "
             "match it")
    return found[0]


def check_trials(label, solver, dev, card, smis, n_val_b, n_test_b):
    """Every trial of a search exited 0, wrote its final line and its
    result.json; its own kernel launches (counted in the trial process,
    written to result.json) are those its config implies, exactly; its
    best_save.pt serves ``smis`` on the card as on the CPU, with the
    launches its config implies.  Returns (launches of the trials' own
    training, launches of serving their checkpoints here)."""
    import numpy as np
    from glam_tpu_torch.serve import Predictor
    trained = dict.fromkeys(read_counts(), 0)
    served = dict.fromkeys(read_counts(), 0)
    if solver.failed_trials:
        fail(f"automl [{label}]: {solver.failed_trials} trials failed")
    for t in solver.trials:
        cfg = t["config"]
        if t["proc"].returncode != 0:
            fail(f"automl [{label}]: trial {cfg['note']} exited "
                 f"{t['proc'].returncode}")
        run_dir, res = trial_run_dir(solver, t)
        last = (run_dir / "log.txt").read_text().strip().splitlines()[-1]
        parts = last.split("|")
        if len(parts) != 3 or not all(isinstance(ast.literal_eval(q), dict)
                                      for q in parts):
            fail(f"automl [{label}]: {run_dir.name} lacks its final line: "
                 f"{last!r}")
        val = ast.literal_eval(parts[2])
        steps, epochs = res["optimizer_steps"], res["epochs_trained"]
        forwards = steps + (epochs + 1) * n_val_b + n_test_b
        pf = per_forward(cfg)
        want = {"triplet_fused_fwd": pf["triplet_fused_fwd"] * forwards,
                "triplet_fused_bwd": pf["triplet_fused_fwd"] * steps,
                "segment_softmax_spmm_fwd":
                    pf["segment_softmax_spmm_fwd"] * forwards,
                "segment_softmax_spmm_bwd":
                    pf["segment_softmax_spmm_fwd"] * steps}
        check_counts(f"automl [{label}] trial {cfg['note']} (its own "
                     "process)", res["kernel_launches"], want)
        if not res.get("step_graphs"):
            fail(f"automl [{label}]: trial {cfg['note']} ran its steps "
                 f"eagerly: {res.get('step_graphs_reason')}")
        gs = res["step_graph_stats"]
        for k, n in res["kernel_launches"].items():
            trained[k] += n
        if not (run_dir / "best_save.pt").is_file():
            fail(f"automl [{label}]: {run_dir.name} saved no best_save.pt")
        on_card = Predictor.from_checkpoint(run_dir, device=dev)
        on_cpu = Predictor.from_checkpoint(run_dir, device="cpu")
        reset_counts()
        a = on_card.predict_smiles(smis)
        got = read_counts()
        b = on_cpu.predict_smiles(smis)
        n_b = len(on_card.batches([g for g in on_card.featurize(smis)
                                   if g is not None]))
        check_counts(f"automl [{label}] serving {run_dir.name}", got,
                     {k: n * n_b for k, n in pf.items()})
        for k, n in got.items():
            served[k] += n
        err = float(np.abs(a - b).max())
        if not (np.isfinite(a).all() and np.allclose(a, b, rtol=TOL,
                                                     atol=TOL)):
            fail(f"automl [{label}] {run_dir.name}: card and CPU differ by "
                 f"{err}")
        hid = on_card.model.cfg.hid_dim
        print(f"  trial {cfg['note']} seed {cfg['seed']} card {cfg['gpu']}: "
              f"{cfg['mol_block']} {cfg['mol_readout']} hid={hid} "
              f"steps={cfg['message_steps']} batch={cfg['batch_size']} "
              f"e_dim={cfg['e_dim']} {cfg['optim']} lr={cfg['lr']} "
              f"loss={cfg['loss']} epochs={epochs}: wall_s="
              f"{t['seconds']:.2f} (start-up "
              f"{t['seconds'] - res['seconds']:.2f}, training steps "
              f"{res['train_seconds']:.2f}, evaluation and checkpoints "
              f"{res['seconds'] - res['train_seconds']:.2f}; CUDA graphs: "
              f"{gs['captures']} captures in {gs['capture_s']:.2f} s, "
              f"warm-up groups {gs['warmup_s']:.2f} s, {gs['replays']} "
              f"replays, pool {gs['pool_bytes'] / 2**20:.1f} MiB) "
              f"optimizer_steps={steps} valr2="
              f"{val.get('valr2', float('nan')):.4f} valrmse="
              f"{val.get('valrmse', float('nan')):.4f} exit=0; own launches "
              f"{json.dumps(res['kernel_launches'])} = per forward "
              f"{json.dumps(pf)} x {forwards} forwards, x {steps} steps; "
              f"best_save.pt {len(smis)} SMILES card vs CPU max_abs_err="
              f"{err:.3e} (tol {TOL}), launches {json.dumps(got)} = x {n_b} "
              f"batches ({card})")
    return trained, served


def automl_phase(dev, card, demo, tmp):
    """The AutoML solver on physprop_perturb at the search's widths:
    kernel checks at the widths it draws; the low-fidelity search at 1
    slot and the whole search (``glam.main``) at 4 slots on the one card,
    timed and the card sampled; every trial checked; the blend and PASP
    launches (this process) exact; ``EnsemblePredictor`` card vs CPU."""
    import numpy as np
    from glam_tpu_torch.automl.summary import select_top_runs
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.perturb import PerturbationDataset, perturb_test
    from glam_tpu_torch.serve import EnsemblePredictor

    cuda_context_check()
    configs = automl_configs()
    for c in configs:
        print(f"automl: seed {AUTOML_SEED} samples {c['mol_block']} "
              f"{c['mol_readout']} hid={15 * c['hid_dim_alpha']} steps="
              f"{c['message_steps']} batch={c['batch_size']} e_dim="
              f"{c['e_dim']} {c['optim']} lr={c['lr']} loss={c['loss']}")
    kinds = {k for c in configs for k, _, _, _ in config_calls(c)}
    if "triplet" not in kinds or not kinds & {"light", "gat", "set2set",
                                              "lapool"}:
        fail(f"automl seed {AUTOML_SEED}: the sampled configurations hold "
             f"{sorted(kinds)}: no _TripletMessage or no kernel C user")

    root = Path(tmp) / "physprop_checks"
    shutil.copytree(PHYSPROP_CSV.parent, root / "raw")
    ds = PerturbationDataset(str(root))
    print(f"automl: physprop_perturb {len(ds.graphs)} molecules, label "
          f"split {len(ds.train)} / {len(ds.val)} / {len(ds.test)}")
    widths = automl_width_checks(dev, card, demo, ds)

    n_val_b = math.ceil(len(ds.val) / 32)
    n_test_b = math.ceil(len(ds.test) / 32)
    smis = [g.smi for g in ds.test[:37]]
    results = {}
    for slots, label, full in ((1, "slots1", False), (4, "slots4", True)):
        solver, r = run_search(tmp, slots, label, full)
        print(f"automl search [{label}]: {len(solver.trials)} trials, "
              f"{solver.dm.num_slots} slots on {solver.dm.num_cards} card; "
              f"low-fidelity phase wall_s={r['low_s']:.2f} ({r['util_low']});"
              f" whole run wall_s={r['wall_s']:.2f} ({r['util']}) ({card})")
        r["trained"], r["served"] = check_trials(
            label, solver, dev, card, smis, n_val_b, n_test_b)
        results[label] = (solver, r)
    os.environ.pop("GLAM_TPU_TRIAL_SLOTS", None)

    # the blend and PASP ran in this process during glam.main: their
    # launches are those of the selected runs' forwards, exactly
    solver, r = results["slots4"]
    configs = [t["config"] for t in solver.trials[:len(configs)]]
    sel = select_top_runs(solver.logs_dir, "physprop_perturb",
                          AUTOML_ARGS["n_top_blend"])
    sel_cfgs = [ast.literal_eval(x["config"]) for x in sel]
    levels = {lv: perturb_test(str(root), "physprop_perturb", lv)
              for lv in (1, 2, 3)}
    pasp_batches = sum(math.ceil(len(m) / 32) + math.ceil(len(mp) / 32)
                       for m, mp, _, _ in levels.values())
    want_blend, want_pasp = dict.fromkeys(read_counts(), 0), dict.fromkeys(
        read_counts(), 0)
    for c in sel_cfgs:
        for k, n in per_forward(c).items():
            want_blend[k] += n * n_test_b
            want_pasp[k] += n * pasp_batches
    reset_counts()
    again = solver.blend_and_inference()
    blend_launches = read_counts()
    check_counts("automl blend_and_inference", blend_launches, want_blend)
    pasp_launches = {k: r["launches"][k] - blend_launches[k]
                     for k in blend_launches}
    check_counts("automl pasp_ensemble", pasp_launches, want_pasp)
    if not all(math.isfinite(v) for v in again.values()) or any(
            abs(again[k] - v) > 1e-6 * max(1.0, abs(v))
            for k, v in solver.blend_result.items()):
        fail(f"automl blend: {again} again, {solver.blend_result} in "
             "glam.main")
    deltas = solver.pasp_result or {}
    if sorted(deltas) != [1, 2, 3] or not all(
            math.isfinite(v) for v in deltas.values()):
        fail(f"automl PASP: Delta_RMSE {deltas}")
    print(f"automl blend of {[x['id'] for x in sel]} "
          f"({[c['note'] + ' ' + c['mol_block'] for c in sel_cfgs]}): "
          f"rmse={again['rmse']:.4f} r2={again['r2']:.4f} mse="
          f"{again['mse']:.4f} ci={again['ci']:.4f}; launches "
          f"{json.dumps(blend_launches)} = sum over the runs of "
          f"{n_test_b} test batches x launches per forward")
    print(f"automl PASP: Delta_RMSE level 1 {deltas[1]:.6f}, level 2 "
          f"{deltas[2]:.6f}, level 3 {deltas[3]:.6f}; launches "
          f"{json.dumps(pasp_launches)} = sum over the runs of "
          f"{pasp_batches} batches (M and M' at levels 1-3) x launches per "
          f"forward ({card})")

    ens_card = EnsemblePredictor.from_runs(solver.logs_dir, n=2, device=dev)
    ens_cpu = EnsemblePredictor.from_runs(solver.logs_dir, n=2,
                                          device="cpu")
    reset_counts()
    a = ens_card.predict_smiles(smis)
    ens_launches = read_counts()
    b = ens_cpu.predict_smiles(smis)
    check_counts("automl EnsemblePredictor", ens_launches, {
        k: 2 * sum(per_forward(c)[k] for c in sel_cfgs)
        for k in per_forward(sel_cfgs[0])})
    if not (np.isfinite(a).all() and np.allclose(a, b, rtol=TOL, atol=TOL)):
        fail(f"EnsemblePredictor: card and CPU differ by "
             f"{np.abs(a - b).max()}")
    for p in ens_card.predictors:
        replays_bitwise("automl EnsemblePredictor", p, smis,
                        p.predict_smiles(smis))
    served_graphs("automl EnsemblePredictor", ens_card, card)
    print(f"automl EnsemblePredictor.from_runs(n=2): {len(smis)} SMILES "
          f"card vs CPU max_abs_err={float(np.abs(a - b).max()):.3e} (tol "
          f"rtol {TOL} + atol {TOL}); launches {json.dumps(ens_launches)}")

    # each trial config's kernel calls at its trainer's batch (a first
    # batch at the loader's budgets) and at the blend's test batch (32
    # molecules of the test split)
    rng = np.random.RandomState(9)
    at = {}
    for c in configs:
        for where, graphs, bs in (("train", ds.train, c["batch_size"]),
                                  ("test", ds.test, 32)):
            batch = next(iter(GraphLoader(graphs, bs, 1, shuffle=where ==
                                          "train", seed=12)))
            for kind, H, C, _ in config_calls(c):
                key = f"{where}{bs}_{kind}_c{C}"
                if key in at:
                    continue
                if kind == "triplet":
                    at[key] = {w: check_kernel(
                        w, f"automl_{where}{bs}_h3_c{C}", batch_csr(batch),
                        rng, dev, card, 3, C) for w in ("fwd", "bwd")}
                else:
                    at[key] = check_spmm_both(
                        f"automl_{where}{bs}_{kind}_h1_c{C}",
                        spmm_call_inputs(kind, batch, C, rng, dev), dev,
                        card)
    searched = dict.fromkeys(read_counts(), 0)
    served = dict.fromkeys(read_counts(), 0)
    for _, rr in results.values():
        for k in searched:
            searched[k] += rr["trained"][k]
            served[k] += rr["served"][k]
    return {"configs": configs, "selected": sel_cfgs, "at": at,
            "widths": widths, "launches": {
                "automl_search": searched, "automl_trials": served,
                "automl_blend": r["launches"]}}


# ---------- native featurizer, JAX checkpoints, viz, bfloat16 training
JAX_FIXTURES = ROOT / "tests" / "data" / "jax_ckpt"
# the fixtures' modes (scripts/make_jax_ckpt_fixtures.py writes the JAX
# Visualizer's weights in each)
VIZ_MODES = {"flagship": ("hidden_node", "triplet_attention"),
             "light_set2set_bn": ("set2set_attention",)}
BF16_TRAIN_ARGS = TRAIN_ARGS + ["--dtype", "bfloat16"]
BF16_LIBRARY_ARGS = ["--epochs", "1"] + LIBRARY_ARGS[2:] + ["--dtype",
                                                            "bfloat16"]
# card against CPU at --dtype bfloat16: both bfloat16 gradient trees
# approximate the float32 one (bfloat16 keeps 8 bits of mantissa, and the
# card's and the CPU's bfloat16 matmuls round partial sums differently),
# and the card's largest distance from it, as a share of the tree's
# largest entry, may be at most BF16_GRAD_TOL times the CPU's (plus 1e-3)
BF16_GRAD_TOL = 2.0
# the Python featurizer's share of serving the demo corpus, measured by
# this script before serving featurized natively (H100 80GB HBM3, 700 W)
PYTHON_FEATURIZE = ("Python featurizer before: 0.6465 s of 0.8761 s, "
                    "1414.3 mol/s")
STEP_TIMES = {}


def _outcomes(fn, smis):
    out = []
    for smi in smis:
        try:
            out.append(fn(smi))
        except ValueError:
            out.append(None)
    return out


def native_phase(card):
    """The C++ featurizer against the Python one, byte for byte, on the
    demo corpus and on physprop (whose 2 hypervalent-iodine SMILES both
    must reject); each featurizer's seconds and molecules/s."""
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.chem.native import smiles_to_arrays_native
    from glam_tpu_torch.data.datasets import read_csv
    corpora = {"demo": read_demo(),
               "physprop": read_csv(PHYSPROP_CSV)[1]["SMILES"]}
    for name, smis in corpora.items():
        res, secs = {}, {}
        for label, fn in (("native", smiles_to_arrays_native),
                          ("python", smiles_to_arrays)):
            t0 = time.perf_counter()
            res[label] = _outcomes(fn, smis)
            secs[label] = time.perf_counter() - t0
        bad = []
        for smi, a, b in zip(smis, res["native"], res["python"]):
            if (a is None) != (b is None) or (a is not None and not all(
                    x.dtype == y.dtype and x.shape == y.shape
                    and x.tobytes() == y.tobytes() for x, y in zip(a, b))):
                bad.append(smi)
        if bad:
            fail(f"native featurizer differs from the Python one on "
                 f"{len(bad)} {name} SMILES, e.g. {bad[:3]}")
        rejected = [s for s, a in zip(smis, res["native"]) if a is None]
        if name == "physprop" and (len(rejected) != 2 or not all(
                "I" in s for s in rejected)):
            fail(f"physprop: expected the 2 hypervalent iodine SMILES to "
                 f"reject, got {rejected}")
        n = len(smis)
        print(f"native [{name}]: {n} SMILES, {len(rejected)} rejected by "
              f"both {rejected[:2]}; byte-identical; native "
              f"{secs['native']:.4f} s = {n / secs['native']:.1f} mol/s, "
              f"python {secs['python']:.4f} s = "
              f"{n / secs['python']:.1f} mol/s, "
              f"{secs['python'] / secs['native']:.2f}x ({card})")


def _fixture(name):
    import numpy as np
    d = JAX_FIXTURES / name
    return d, np.load(d / "expected.npz")


def _served_batches(pred, smis):
    valid = [g for g in pred.featurize(smis) if g is not None]
    return pred.batches(valid)


def jax_checkpoint_phase(dev, card, tmp):
    """Both committed JAX checkpoints served on the card through
    ``Predictor.from_checkpoint(..., which="best_save.ckpt")``, then by
    ``EnsemblePredictor.from_runs`` over the two: scores within TOL of
    the JAX package's (``expected.npz``), NaN rows at the invalid SMILES,
    launches exact.  Returns the launches and the kernel checks at the
    first served batch's shapes."""
    import dataclasses
    import numpy as np
    import torch
    from glam_tpu_torch.serve import EnsemblePredictor, Predictor

    total = {k: 0 for k in read_counts()}
    kern, want_all = {}, {}
    rng = np.random.RandomState(8)
    for name in VIZ_MODES:
        d, exp = _fixture(name)
        smis = [str(s) for s in exp["smiles"]]
        pred = Predictor.from_checkpoint(d, which="best_save.ckpt",
                                         batch_size=128, device=dev)
        pred.predict_smiles(smis[:16])              # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = pred.predict_scores(smis)
        secs = time.perf_counter() - t0
        launches = read_counts()
        want = exp["scores"]
        invalid = np.isnan(want[:, 0])
        if not (np.isnan(got[invalid]).all() and np.isfinite(
                got[~invalid]).all() and invalid.sum() == 3):
            fail(f"JAX checkpoint {name}: NaN rows differ from the JAX "
                 "package's")
        err = float(np.nanmax(np.abs(got - want)))
        if not np.allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True):
            fail(f"JAX checkpoint {name}: card scores differ from the JAX "
                 f"package's by {err}")
        batches = _served_batches(pred, smis)
        per = per_forward(dataclasses.asdict(pred.model.cfg))
        check_counts(f"serving JAX checkpoint {name}", launches,
                     {k: n * len(batches) for k, n in per.items()})
        replays_bitwise(f"jax_checkpoint [{name}]", pred, smis,
                        pred.predict_smiles(smis))
        served_graphs(f"jax_checkpoint [{name}]", pred, card)
        for k, n in launches.items():
            total[k] += n
        want_all[name] = (want, len(batches), per)
        cfg = pred.model.cfg
        print(f"jax_checkpoint [{name}]: {cfg.mol_block} {cfg.mol_readout} "
              f"hid={cfg.hid_dim} steps={cfg.message_steps} e_dim="
              f"{cfg.e_dim} norms graph={cfg.graph_norm} flat="
              f"{cfg.flat_norm}: {len(smis)} SMILES ({int(invalid.sum())} "
              f"invalid, NaN rows) in {len(batches)} batches, "
              f"{secs:.4f} s; card vs the JAX package's scores "
              f"max_abs_err={err:.3e} (tol rtol {TOL} + atol {TOL}); "
              f"launches {json.dumps(launches)} = per forward "
              f"{json.dumps(per)} x {len(batches)} batches ({card})")
        if cfg.mol_block == "_TripletMessage":
            kern["flagship"] = check_kernel(
                "fwd", "serve_jax_flagship128", batch_csr(batches[0]), rng,
                dev, card)
        else:
            kern["set2set"] = check_spmm_calls(
                "serve_jax", batches[0], cfg.mol_block, cfg.mol_readout,
                cfg.hid_dim, rng, dev, card)

    logs = Path(tmp) / "jax_runs" / "log_demo"
    for i, name in enumerate(VIZ_MODES):
        shutil.copytree(JAX_FIXTURES / name, logs / f"jax{i}_seed_0")
    ens = EnsemblePredictor.from_runs(logs, n=2, batch_size=128,
                                      device=dev)
    smis = [str(s) for s in _fixture("flagship")[1]["smiles"]]
    reset_counts()
    got = ens.predict_scores(smis)
    launches = read_counts()
    want = np.mean([w for w, _, _ in want_all.values()], axis=0)
    expect = {}
    for _, n_b, per in want_all.values():
        for k, n in per.items():
            expect[k] = expect.get(k, 0) + n * n_b
    check_counts("EnsemblePredictor over the JAX runs", launches, expect)
    err = float(np.nanmax(np.abs(got - want)))
    if len(ens.predictors) != 2 or not np.allclose(
            got, want, rtol=TOL, atol=TOL, equal_nan=True):
        fail(f"EnsemblePredictor over the JAX runs: differs from the mean "
             f"of the JAX package's scores by {err}")
    for k, n in launches.items():
        total[k] += n
    for p in ens.predictors:
        replays_bitwise("jax_checkpoint EnsemblePredictor", p, smis,
                        p.predict_smiles(smis))
    served_graphs("jax_checkpoint EnsemblePredictor", ens, card)
    print(f"jax_checkpoint EnsemblePredictor.from_runs over both JAX runs: "
          f"{len(smis)} SMILES, card vs the mean of the JAX package's "
          f"scores max_abs_err={err:.3e} (tol {TOL}); launches "
          f"{json.dumps(launches)} ({card})")
    return total, kern


def viz_phase(dev, card):
    """``Visualizer.weights`` over the JAX checkpoints on the card in
    every fixture mode: within TOL of the JAX Visualizer's weights,
    launches exact (one forward per molecule)."""
    import dataclasses
    import numpy as np
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import featurize_smiles
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.serve import Predictor
    from glam_tpu_torch.viz.attention import Visualizer

    total = {k: 0 for k in read_counts()}
    kern = {}
    rng = np.random.RandomState(9)
    for name, modes in VIZ_MODES.items():
        d, exp = _fixture(name)
        smis = [str(s) for s in exp["viz_smiles"]]
        pred = Predictor.from_checkpoint(d, which="best_save.ckpt",
                                         device=dev)
        per = per_forward(dataclasses.asdict(pred.model.cfg))
        for mode in modes:
            reset_counts()
            t0 = time.perf_counter()
            weights = Visualizer(pred, mode).weights(smis)
            secs = time.perf_counter() - t0
            launches = read_counts()
            errs = []
            for i, w in enumerate(weights):
                ref = exp[f"viz_{mode}_{i}"]
                if w.shape != ref.shape:
                    fail(f"viz {name} {mode}: molecule {i} weights of shape "
                         f"{w.shape}, JAX's {ref.shape}")
                errs.append(float(np.abs(w - ref).max()))
            if max(errs) > TOL:
                fail(f"viz {name} {mode}: card weights differ from the JAX "
                     f"Visualizer's by {max(errs)}")
            check_counts(f"viz {name} {mode}", launches,
                         {k: n * len(smis) for k, n in per.items()})
            for k, n in launches.items():
                total[k] += n
            print(f"viz [{name} {mode}]: {len(smis)} molecules, weights "
                  f"{[list(w.shape) for w in weights][:3]}..., card vs the "
                  f"JAX Visualizer max_abs_err={max(errs):.3e} (tol {TOL}) "
                  f"in {secs:.4f} s; launches {json.dumps(launches)} = per "
                  f"forward {json.dumps(per)} x {len(smis)} molecules "
                  f"({card})")
        x, snd, rcv, e = featurize_smiles(smis[0])
        batch = next(iter(GraphLoader([GraphArrays(
            x, e, snd, rcv, np.zeros(1, np.float32))], 1, 1)))
        cfg = pred.model.cfg
        if cfg.mol_block == "_TripletMessage":
            kern["flagship"] = check_kernel("fwd", "viz_mol", batch_csr(
                batch), rng, dev, card)
        else:
            kern["set2set"] = check_spmm_calls(
                "viz", batch, cfg.mol_block, cfg.mol_readout, cfg.hid_dim,
                rng, dev, card)
    return total, kern


def bf16_phase(dev, card, tmp, label, flags, f32_label):
    """``glam_tpu_torch.run --dtype bfloat16``: the final line finite,
    the masters float32 (the trainer's and its best_save.pt), the
    launches exact, one step's gradients card vs CPU, and the step's
    times beside the float32 run's.  Returns the launches, the trainer's
    batch and the trainer."""
    import dataclasses
    import torch

    trainer, launches, steps, forwards = run_cli(tmp, flags, label)
    cfg = trainer.model.cfg
    per = per_forward(dataclasses.asdict(cfg))
    want = {"triplet_fused_fwd": per["triplet_fused_fwd"] * forwards,
            "triplet_fused_bwd": per["triplet_fused_fwd"] * steps,
            "segment_softmax_spmm_fwd": per["segment_softmax_spmm_fwd"]
            * forwards,
            "segment_softmax_spmm_bwd": per["segment_softmax_spmm_fwd"]
            * steps}
    check_counts(f"{label} training", launches, want)
    if trainer.compute_dtype != torch.bfloat16:
        fail(f"{label}: compute dtype {trainer.compute_dtype}")
    saved = torch.load(trainer.log_save_dir / "best_save.pt",
                       weights_only=True)["state_dict"]
    dtypes = {p.dtype for p in trainer.model.parameters()} | {
        t.dtype for t in saved.values() if t.is_floating_point()}
    if dtypes != {torch.float32}:
        fail(f"{label}: master parameters are {dtypes}, not float32")
    print(f"training [{label}]: compute dtype bfloat16, master parameters "
          f"and best_save.pt float32; launches {json.dumps(launches)} = "
          f"per forward {json.dumps(per)} x {forwards} forwards / "
          f"{steps} steps ({card})")
    batch = next(iter(trainer.train_loader))
    grads_card_vs_cpu(trainer, cfg, batch, dev,
                      train_mode=cfg.graph_norm == "_BatchNorm")
    timing = step_timing(trainer, batch.to(dev), card, epochs=False)
    f32 = STEP_TIMES[f32_label]
    print(f"training step [{label} vs {f32_label} float32]: step_ms "
          f"{timing['step_ms']:.4f} vs {f32['step_ms']:.4f}, device_ms "
          f"{timing['device_ms']:.4f} vs {f32['device_ms']:.4f}, busy_ms "
          f"{timing['busy_ms']:.4f} vs {f32['busy_ms']:.4f}, device "
          f"kernels {timing['kernels']} vs {f32['kernels']} ({card})")
    return launches, batch, trainer


def bf16_training(dev, card, tmp):
    """The flagship (2 epochs) and TripletMessageLight + Set2Set with
    BatchNorm (1 epoch) at --dtype bfloat16; kernels A and B, and C both
    ways, at each trainer's batch."""
    import numpy as np
    launches, batch, _ = bf16_phase(dev, card, tmp, "flagship_bf16",
                                    BF16_TRAIN_ARGS, "flagship")
    rng = np.random.RandomState(10)
    kern_a = {w: check_kernel(w, "train_bf16_batch", batch_csr(batch), rng,
                              dev, card) for w in ("fwd", "bwd")}
    lib_launches, batch, trainer = bf16_phase(
        dev, card, tmp, "light_set2set_bf16", BF16_LIBRARY_ARGS,
        "light_set2set")
    cfg = trainer.model.cfg
    kern_c = check_spmm_calls("train_bf16", batch, cfg.mol_block,
                              cfg.mol_readout, cfg.hid_dim, rng, dev, card)
    return launches, kern_a, lib_launches, kern_c



def grads_card_vs_cpu(trainer, cfg, batch, dev, train_mode=False,
                      state=None):
    """One Adam step from the same weights on the same batch (a
    ``GraphBatch``, or a pair of them for a pair model) on the card and
    on the CPU: the parameter gradients must agree.  In eval mode (no
    noise, so both draw none), or with ``train_mode`` in training mode
    (batch statistics in BatchNorm) with the config's dropout and RReLU
    noise taken out.  The weights are ``state``, or the trainer's.  In
    the trainer's compute dtype (``compute_forward``); under bfloat16
    the card's gradients must lie as close to the CPU's float32 ones as
    the CPU's bfloat16 ones do (BF16_GRAD_TOL) instead."""
    import dataclasses
    import torch
    from glam_tpu_torch.nn.model import Architecture, PairArchitecture
    from glam_tpu_torch.train.optim import make_optimizer
    from glam_tpu_torch.train.trainer import compute_forward

    dtype = trainer.compute_dtype

    if train_mode:
        cfg = dataclasses.replace(
            cfg, pre_do="_None()", graph_do="_None()", flat_do="_None()",
            end_do="_None()", pre_act="CELU", graph_act="CELU",
            flat_act="CELU", end_act="CELU")
    if isinstance(trainer.model, PairArchitecture):
        hetero = trainer.model.hetero
        build = lambda: PairArchitecture(cfg, hetero)  # noqa: E731
    else:
        build = lambda: Architecture(cfg)  # noqa: E731
    if state is None:
        state = {k: v.detach().cpu().clone()
                 for k, v in trainer.model.state_dict().items()}
    grads, params = {}, {}
    runs = [("cpu", "cpu", dtype), ("card", dev, dtype)]
    if dtype != torch.float32:
        runs.append(("cpu_f32", "cpu", torch.float32))
    for key, d, dt in runs:
        model = build().to(d)
        model.load_state_dict(state)
        model.train(train_mode)
        opt = make_optimizer("Adam", model.named_parameters(), 1e-3)
        b = [p.to(d) for p in trainer._as_parts(batch)]
        loss = trainer.loss_fn(compute_forward(model, b, dt), b[0].y,
                               b[0].graph_mask)
        opt.zero_grad()
        loss.backward()
        opt.step()
        grads[key] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        params[key] = {n: p.detach().cpu() for n, p in
                       model.named_parameters()}
    worst, worst_name, zero = 0.0, "", []
    tree = max(float(g.abs().max()) for g in grads["cpu"].values())
    if dtype != torch.float32:
        # both bfloat16 gradients approximate the float32 one; the card's
        # must do so as well as the CPU's
        ref = grads["cpu_f32"]
        tree = max(float(g.abs().max()) for g in ref.values())
        errs = {}
        for key in ("card", "cpu"):
            e = {n: float((g - ref[n]).abs().max()) / tree
                 for n, g in grads[key].items()}
            if any(g.dtype != torch.float32 for g in grads[key].values()):
                fail(f"{key} gradients are not all float32")
            errs[key] = max(e.items(), key=lambda kv: kv[1])
        between = max(float((grads["card"][n] - g).abs().max()) / tree
                      for n, g in grads["cpu"].items())
        if not errs["card"][1] <= BF16_GRAD_TOL * errs["cpu"][1] + 1e-3:
            fail(f"gradients at {dtype}: the card's lie {errs['card'][1]:.3e}"
                 f" of the tree's largest from float32 ({errs['card'][0]}),"
                 f" the CPU's {errs['cpu'][1]:.3e}")
        print(f"one Adam step card vs CPU [{cfg.mol_block} "
              f"{cfg.mol_readout}, {dtype}, "
              f"{'train' if train_mode else 'eval'} mode] "
              f"({len(ref)} float32 gradient tensors): distance from the "
              f"CPU's float32 gradients, as a share of the tree's largest "
              f"entry {tree:.3e}: card {errs['card'][1]:.3e} "
              f"({errs['card'][0]}), CPU {errs['cpu'][1]:.3e} "
              f"({errs['cpu'][0]}; tol card <= {BF16_GRAD_TOL} x CPU + "
              f"1e-3); card vs CPU {between:.3e}")
        return
    for name, gc in grads["cpu"].items():
        gg = grads["card"][name]
        scale, card = float(gc.abs().max()), float(gg.abs().max())
        if scale <= GRAD_ZERO * tree:
            zero.append(f"{name} (cpu {scale:.3e}, card {card:.3e})")
            if card > GRAD_ZERO * tree:
                fail(f"gradient of {name}: zero to rounding on the CPU "
                     f"({scale:.3e}) but {card:.3e} on the card (tree's "
                     f"largest {tree:.3e})")
            continue
        err = float((gg - gc).abs().max())
        if not torch.allclose(gg, gc, rtol=GRAD_RTOL,
                              atol=GRAD_ATOL * scale):
            fail(f"gradient of {name}: card and CPU differ by {err:.3e} "
                 f"(scale {scale:.3e})")
        if err / scale > worst:
            worst, worst_name = err / scale, name
    dp = max(float((params["card"][n] - params["cpu"][n]).abs().max())
             for n in params["cpu"])
    towers = (f" + {cfg.pro_block} protein tower"
              if getattr(trainer.model, "hetero", False) else "")
    print(f"one Adam step card vs CPU [{cfg.mol_block} "
          f"{cfg.mol_readout}{towers}, "
          f"{'train' if train_mode else 'eval'} mode] "
          f"({len(grads['cpu'])} parameter "
          f"tensors): max gradient error {worst:.3e} of the tensor's "
          f"largest entry ({worst_name}; tol rtol {GRAD_RTOL} + atol "
          f"{GRAD_ATOL} x largest entry); zero to rounding, under "
          f"{GRAD_ZERO} x the tree's largest {tree:.3e} on both: "
          f"{', '.join(zero) or 'none'}; max weight difference after the "
          f"step {dp:.3e}")


def per_launch(calls):
    """The mean numbers of one launch over a path's ``calls`` ({call:
    (launches per forward, numbers)}), each call weighted by its
    launches; bound_by is that of the call with the largest share of the
    bound."""
    total = sum(w for w, _ in calls.values())
    out = {key: sum(w * r[key] for w, r in calls.values()) / total
           for key in ("ms", "plain_ms", "bound_ms",
                       "bound_with_row_stats_ms")}
    out["bound_by"] = max(calls.values(),
                          key=lambda wr: wr[0] * wr[1]["bound_ms"])[1][
                              "bound_by"]
    return out


def noise_free(cfg):
    """``cfg`` without Dropout and with CELU for RReLU: a model that
    draws no noise."""
    import dataclasses
    return dataclasses.replace(
        cfg, pre_do="_None()", graph_do="_None()", flat_do="_None()",
        end_do="_None()", pre_act="CELU", graph_act="CELU",
        flat_act="CELU", end_act="CELU")


def build_model(trainer, cfg):
    """A fresh model of ``trainer``'s kind (single-graph or pair) from
    ``cfg``, on the trainer's device."""
    from glam_tpu_torch.nn.model import Architecture, PairArchitecture
    if isinstance(trainer.model, PairArchitecture):
        return PairArchitecture(cfg, trainer.model.hetero).to(trainer.device)
    return Architecture(cfg).to(trainer.device)


# captured against eager: 2 x 8 + 3 steps, as the trainer groups them at
# --scan_steps 8 (a group of 8 run eagerly as the warm-up, one replay of
# the 8-step graph, then 3 replays of the one-step graph), with a
# ReduceLROnPlateau cut of the learning rate between the 8-step replay
# and the one-step ones; Ranger's 13 steps at S = 4 (one eager warm-up
# step, then three replays of its 4-step graph: steps 2-5, 6-9 (its
# N_sma threshold and first Lookahead sync) and 10-13 (the second))
PLAN_19 = [(0, 8, True), (8, 16, True), "lr", (16, 19, False)]
PLAN_RANGER = [(0, 1, False), (1, 5, True), (5, 9, True), (9, 13, True)]
GRAPH_RTOL, GRAPH_ATOL = 1e-4, 1e-6


def captured_vs_eager(label, trainer, card, optim="Adam", noise=False,
                      plan=PLAN_19, lr=1e-3):
    """From one state (the trainer's weights), the steps of ``plan`` over
    the trainer's own loader batches through ``StepGraphs`` (its replays'
    launches counted) and the same steps eagerly, three times: the
    parameters, the BatchNorm statistics and the optimizer state after
    them, the losses, and the launches.  Each tensor of the captured run
    must lie within rtol GRAPH_RTOL + GRAPH_ATOL x its largest entry of
    the first eager run's, or, as a share of its largest entry, within
    GRAPH_RTOL beyond twice the largest such share between two eager runs
    (B's d_xp and index_add_'s atomics change the last bits of a
    gradient, in another order when the kernels run back to back in a
    replay, and Adam's steps move a parameter by its full rate whatever a
    near-zero gradient's size).  The losses are held alike.  With
    ``noise`` the model draws Dropout masks and RReLU slopes from the
    trainer's generator, so the losses say that the graphs' Philox draws
    are the eager ones.  Restores the trainer's model and optimizer.
    Returns the line's numbers."""
    import itertools
    import torch
    from glam_tpu_torch.train.optim import (ReduceLROnPlateau,
                                            get_learning_rate,
                                            make_optimizer,
                                            set_learning_rate)
    from glam_tpu_torch.train.step_graph import StepGraphs
    saved = trainer.model, trainer.optimizer, trainer.step_graphs
    cfg = trainer.model.cfg if noise else noise_free(trainer.model.cfg)
    state = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    n = max(b for step in plan if step != "lr" for _, b, _ in [step])
    host = [trainer._as_parts(h) for h in itertools.islice(
        itertools.cycle(trainer.train_loader), n)]
    runs = {}
    for run in ("eager", "captured", "eager_2", "eager_3"):
        model = build_model(trainer, cfg)
        model.load_state_dict(state)
        model.train()
        trainer.model = model
        trainer.optimizer = make_optimizer(optim, model.named_parameters(),
                                           lr, k=6)
        trainer.generator.manual_seed(29)
        plateau = ReduceLROnPlateau(factor=0.7, patience=0)
        graphs = StepGraphs(trainer._step, trainer._eval_step,
                            trainer.device, trainer.generator)
        reset_counts()
        losses = []
        for step in plan:
            if step == "lr":
                plateau.step(1.0, lr)
                set_learning_rate(trainer.optimizer,
                                  plateau.step(2.0, lr))
                continue
            a, b, stack = step
            if run == "captured":
                losses.append(graphs.train(host[a:b], stack))
            else:
                losses.append(torch.stack([
                    trainer._step(tuple(p.to(trainer.device) for p in h))
                    for h in host[a:b]]))
        torch.cuda.synchronize()
        opt_state = {f"{i}.{k}": v.detach().clone()
                     for i, st in enumerate(trainer.optimizer.state.values())
                     for k, v in st.items() if torch.is_tensor(v)}
        runs[run] = ({**{k: v.detach().clone() for k, v in
                         model.state_dict().items()}, **opt_state},
                     torch.cat(losses), read_counts(), graphs.stats,
                     get_learning_rate(trainer.optimizer))
    trainer.model, trainer.optimizer, trainer.step_graphs = saved
    return hold_runs(label, optim, noise, plan, runs, card)


def hold_runs(label, optim, noise, plan, runs, card):
    """Hold a captured run against three eager runs from one state
    (``runs``: {eager, captured, eager_2, eager_3: (state, losses,
    launches, graph stats, learning rate)}) as :func:`captured_vs_eager`
    says; prints the line and returns its numbers."""
    import torch
    eager, got = runs["eager"][0], runs["captured"][0]
    others = [runs["eager"][0], runs["eager_2"][0], runs["eager_3"][0]]
    floats = [k for k, v in eager.items()
              if v.is_floating_point() and v.numel()]
    scale = {k: max(float(eager[k].abs().max()), 1e-30) for k in floats}
    err = {k: float((got[k] - eager[k]).abs().max()) / scale[k]
           for k in floats}
    # the eager runs' own spread: the largest distance between two of the
    # three, over the tensors, each as a share of its largest entry
    spread = max(float((b[k] - a[k]).abs().max()) / scale[k]
                 for i, a in enumerate(others) for b in others[i + 1:]
                 for k in floats)
    for k in floats:
        if not (torch.allclose(got[k], eager[k], rtol=GRAPH_RTOL,
                               atol=GRAPH_ATOL * scale[k])
                or err[k] <= 2 * spread + GRAPH_RTOL):
            fail(f"captured vs eager [{label}, {optim}]: {k} differs by "
                 f"{err[k]:.3e} of its largest entry {scale[k]:.3e}; two "
                 f"eager runs lie up to {spread:.3e} apart (tol "
                 f"{GRAPH_RTOL} + 2 x that)")
    worst_name = max(err, key=err.get)
    worst = err[worst_name]
    if runs["captured"][2] != runs["eager"][2]:
        fail(f"captured vs eager [{label}]: launches {runs['captured'][2]} "
             f"against {runs['eager'][2]} eagerly")

    def loss_apart(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    la, le = runs["captured"][1], runs["eager"][1]
    loss_gap = loss_apart(la, le)
    losses = [runs[r][1] for r in ("eager", "eager_2", "eager_3")]
    loss_spread = max(loss_apart(a, b) for i, a in enumerate(losses)
                      for b in losses[i + 1:])
    # another draw moves a step's loss by far more than rounding: the
    # losses, as the state, within GRAPH_RTOL beyond twice the eager
    # runs' own spread
    same_draws = loss_gap <= GRAPH_RTOL + 2 * loss_spread
    if not same_draws:
        fail(f"captured vs eager [{label}]: the losses lie {loss_gap:.3e} "
             f"apart, the eager runs' up to {loss_spread:.3e}: the replays "
             "did not take the eager steps")
    gs = runs["captured"][3]
    print(f"captured vs eager [{label}, {optim}, "
          f"{'RReLU + Dropout' if noise else 'no noise'}]: {len(la)} steps "
          f"({', '.join(str(p) for p in plan)}), {len(eager)} state "
          f"tensors (parameters, BatchNorm statistics, optimizer state): "
          f"max error {worst:.3e} of the tensor's largest entry "
          f"({worst_name}; tol rtol {GRAPH_RTOL} + atol {GRAPH_ATOL} x "
          f"largest, or within {GRAPH_RTOL} + 2 x the eager runs' spread "
          f"{spread:.3e}); losses max rel diff {loss_gap:.3e}, eager runs' "
          f"{loss_spread:.3e} (draws equal: {same_draws}); lr after the "
          f"plateau {runs['captured'][4]:.3e} = eager "
          f"{runs['eager'][4]:.3e}; "
          f"launches equal {json.dumps(runs['captured'][2])}; "
          f"{gs['captures']} captures {gs['capture_s']:.3f} s, pool "
          f"{gs['pool_bytes'] / 2**20:.1f} MiB ({card})")
    return {"max_rel_err": worst, "worst": worst_name,
            "eager_spread": spread, "loss_gap": loss_gap,
            "same_draws": same_draws}


def host_step_ms(fn, reps=20, per=1):
    """Median host-clock ms of ``fn`` (one step, or ``per`` steps), from
    a synchronized start to the end of its device work."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def step_timing(trainer, batch, card, top=8, epochs=True):
    """One optimizer step (forward, backward, update) on a training batch
    (on the card; a pair of them for a pair trainer), eagerly and as the
    replay of a CUDA graph (``StepGraphs``: the one-step graph with its
    slot's copy, and the --scan_steps S-step graph per step), timed in
    turns (eager, captured, S-step, then again): each's median host ms;
    the eager step's device time (launches queued behind a spin) and a
    profile of one eager step and of one replay, with their busy ms,
    kernel counts and idle share (1 - busy / host); the seconds of the
    warm-up and the captures and the graph pool's bytes.  With
    ``epochs``, then whole training epochs in turns (eager, captured with
    its captures, captured twice, eager): samples/s."""
    import torch
    from glam_tpu_torch.train.step_graph import StepGraphs
    trainer.model.train()
    parts = trainer._as_parts(batch)
    host = tuple(p.to("cpu") for p in parts)
    S = max(trainer.scan_steps, 2)
    eager = lambda: trainer.train_step(batch)  # noqa: E731
    dev_ms = device_ms(eager, reps=20, warmup=3, sleep_cycles=200_000_000)
    graphs = StepGraphs(trainer._step, trainer._eval_step, trainer.device,
                        trainer.generator)
    one = lambda: graphs.train([host], False)  # noqa: E731
    group = lambda: graphs.train([host] * S, True)  # noqa: E731
    one()           # the warm-up step, eager
    one()           # the one-step graph's capture, then its replay
    group()         # the S-step graph's capture, then its replay
    ms = {"eager": [], "captured": [], "scan": []}
    for _ in range(2):
        ms["eager"].append(host_step_ms(eager))
        ms["captured"].append(host_step_ms(one))
        ms["scan"].append(host_step_ms(group, reps=5, per=S))
    med = {k: statistics.median(v) for k, v in ms.items()}
    n_mol = int(parts[0].graph_mask.sum())
    shapes = " | ".join(f"N={b.num_nodes} E={b.num_edges} "
                        f"E_real={b.num_real_edges}" for b in parts)
    print(f"training step (batch of {n_mol} samples, {shapes}): "
          f"step_ms={med['eager']:.4f} ({n_mol / med['eager'] * 1e3:.1f} "
          f"samples/s) device_ms={dev_ms:.4f}, medians of 20 CUDA-event "
          f"timings ({card}); device_ms holds only where the step's "
          "launches fit the launch queue behind the spin: see the "
          "profile's busy_ms")
    prof = print_profile("one training step", eager, top)
    captured = print_profile("one captured step (replay)", one, top)
    gs = graphs.stats
    print(f"step graphs [{trainer.args.get('mol_block')}]: host ms a step "
          f"in turns eager {', '.join(f'{v:.4f}' for v in ms['eager'])}, "
          f"one-step replay {', '.join(f'{v:.4f}' for v in ms['captured'])}"
          f", {S}-step replay per step "
          f"{', '.join(f'{v:.4f}' for v in ms['scan'])}; busy ms eager "
          f"{prof['busy_ms']:.4f} over {prof['kernels']} kernels, replay "
          f"{captured['busy_ms']:.4f} over {captured['kernels']} kernels; "
          f"idle share eager {1 - prof['busy_ms'] / med['eager']:.3f}, "
          f"one-step replay {1 - captured['busy_ms'] / med['captured']:.3f},"
          f" {S}-step replay {1 - captured['busy_ms'] / med['scan']:.3f}; "
          f"samples/s eager {n_mol / med['eager'] * 1e3:.1f}, replay "
          f"{n_mol / med['captured'] * 1e3:.1f}, {S}-step "
          f"{n_mol / med['scan'] * 1e3:.1f}; warm-up "
          f"{gs['warmup_s']:.3f} s, {gs['captures']} captures "
          f"{gs['capture_s']:.3f} s, pool {gs['pool_bytes'] / 2**20:.1f} MiB"
          f" ({card})")
    if epochs:
        epoch_timing(trainer, card)
    return dict(prof, step_ms=med["eager"], device_ms=dev_ms)


def epoch_timing(trainer, card):
    """Whole training epochs of the trainer's loader in turns: eager,
    through fresh step graphs (their warm-up group and captures
    included; an epoch of fewer than 2 x 8 batches captures its 8-step
    graph in the second), through them twice more, eager: samples/s of
    each."""
    from glam_tpu_torch.train.step_graph import StepGraphs
    saved = trainer.step_graphs
    graphs = StepGraphs(trainer._step, trainer._eval_step, trainer.device,
                        trainer.generator)
    rates = []
    for turn in ("eager", "captured_first", "captured_second", "captured",
                 "eager"):
        trainer.step_graphs = None if turn == "eager" else graphs
        trainer.train_iterations()
        e = trainer.epoch_stats.pop()
        rates.append((turn, e["molecules"] / e["seconds"], e["seconds"]))
    trainer.step_graphs = saved
    print(f"training epoch [{trainer.args.get('mol_block')}] "
          f"({len(trainer.train_loader)} batches at --scan_steps "
          f"{trainer.scan_steps}) in turns: " + ", ".join(
              f"{t} {r:.1f} samples/s ({sec:.3f} s)" for t, r, sec in rates)
          + f" ({card})")


def phase(label, fn, *args):
    """``fn(*args)``, its wall seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


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
    if sys.argv[1:2] == ["--trace"]:
        trace_main(sys.argv[2])
        return
    if sys.argv[1:2] == ["--stress"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        ab_stress(torch.device("cuda"), int(sys.argv[2]))
        return
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
    native = {}

    def build_native():
        t = time.perf_counter()
        try:
            native["built"] = build.build_host()
        except Exception as err:           # reported after the join
            native["error"] = err
        native["s"] = time.perf_counter() - t

    host = threading.Thread(target=build_native)
    host.start()
    reports = build.build()
    host.join()
    if "error" in native:
        fail(f"native featurizer build failed: {native['error']}")
    print(f"build glam_native.cpp sha={build.host_source_hash('glam_native')}"
          f" ({'built' if native['built'] else 'cached'}): native build "
          f"{native['s']:.2f} s (g++, beside nvcc)")
    for name in build.SOURCES:
        print(f"build {name}.cu sha={build.source_hash(name)} "
              f"({'built' if name in reports else 'cached'})")
        for line in reports.get(name, "").splitlines():
            if "ptxas info" in line or "error" in line:
                print(f"  {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s")

    demo = read_demo()
    phase("native", native_phase, card)
    kern = phase("kernels", kernel_phase, dev, demo, card)
    phase("stress", ab_stress, dev, STRESS_ROUNDS)
    served = phase("serving", serving_phase, dev, demo, card)
    with tempfile.TemporaryDirectory() as tmp:
        jax_served, kern_jax = phase("jax_checkpoint", jax_checkpoint_phase,
                                     dev, card, tmp)
        viz_launches, kern_viz = phase("viz", viz_phase, dev, card)
        trained, kern_train = phase("training", training_phase, dev, card,
                                    tmp)
        lib_trained, lib_served, kern_lib = phase(
            "library", library_phase, dev, card, tmp, demo)
        bf16_a, kern_bf16_a, bf16_c, kern_bf16_c = phase(
            "bf16", bf16_training, dev, card, tmp)
        gat_trained, kern_gat = phase("gat", gat_phase, dev, card, tmp)
        phase("default", default_phase, dev, tmp)
        ddi_trained, kern_ddi, _ = phase("ddi", ddi_phase, dev, card, tmp)
        dti_trained, kern_dti, _ = phase("dti", dti_phase, dev, card, tmp)
        dti_served, kern_srv = phase("dti_serving", dti_serving_phase, dev,
                                     card, demo)
        scr_trained, kern_scr = phase("screening", screening_phase, dev,
                                      card, tmp)
        par = phase("dp, halo, dp_library, dp_pair", dp_phase, dev, card,
                    tmp)
        shd = phase("sharded_dti, sharded_ring, sharded_protein, overlap, "
                    "giant_protein", sharded_phase, dev, card, tmp)
        automl = phase("automl", automl_phase, dev, card, demo, tmp)
    phase("traced kernel checks", report_traced)

    # each kernel's calls on each path: {path: {call: (launches per
    # forward, the numbers measured at that call's shapes)}}; then the
    # checks on no path (random inputs), which count for the error only
    spmm = kern["spmm"]
    calls = {"triplet_fused_fwd": {
                 "serve": {"demo128": (3, kern["fwd"]["serve"])},
                 "train": {"train_batch": (3, kern_train["fwd"])}},
             "triplet_fused_bwd": {
                 "train": {"train_batch": (3, kern_train["bwd"])}}}
    # the pair paths: kernels A and B at each molecule tower's batch
    for w in ("fwd", "bwd"):
        for path, k in (("train_ddi", kern_ddi), ("train_dti", kern_dti),
                        ("train_screening", kern_scr),
                        ("serve_dti", kern_srv)):
            towers = {t: (3, r[w]) for t, r in k.items()
                      if t.startswith("mol") and w in r}
            if towers:
                calls[f"triplet_fused_{w}"][path] = towers
    for w in ("fwd", "bwd"):
        calls[f"segment_softmax_spmm_{w}"] = {
            "serve_light_set2set": {"light": (3, spmm["light"][w]),
                                    "set2set": (3, spmm["set2set"][w])},
            "train_light_set2set": {"light": (3, kern_lib["light"][w]),
                                    "set2set": (3, kern_lib["set2set"][w])},
            "train_gat_lapool": {"gat": (3, kern_gat["gat"][w]),
                                 "lapool": (1, kern_gat["lapool"][w])}}
    for w in ("fwd", "bwd"):
        calls[f"segment_softmax_spmm_{w}"]["train_dti"] = {
            "gat": (3, kern_dti["gat"][w])}
    calls["segment_softmax_spmm_fwd"]["serve_dti"] = {
        "gat": (3, kern_srv["gat"]["fwd"])}
    # bfloat16 training, the JAX checkpoints served, the attention
    # weights
    for w in ("fwd", "bwd"):
        calls[f"triplet_fused_{w}"]["train_flagship_bf16"] = {
            "train_bf16_batch": (3, kern_bf16_a[w])}
        calls[f"segment_softmax_spmm_{w}"]["train_library_bf16"] = {
            c: (3, kern_bf16_c[c][w]) for c in ("light", "set2set")}
    calls["triplet_fused_fwd"]["serve_jax_ckpt"] = {
        "jax_flagship128": (3, kern_jax["flagship"])}
    calls["triplet_fused_fwd"]["viz"] = {"viz_mol": (3, kern_viz["flagship"])}
    for path, k in (("serve_jax_ckpt", kern_jax), ("viz", kern_viz)):
        calls["segment_softmax_spmm_fwd"][path] = {
            c: (3, k["set2set"][c]["fwd"]) for c in ("light", "set2set")}
    del calls["segment_softmax_spmm_bwd"]["serve_light_set2set"]
    off_path = {"triplet_fused_fwd": [kern["fwd"]["hub"],
                                      kern["fwd"]["h8_c64"]],
                "triplet_fused_bwd": [kern["bwd"]["hub"],
                                      kern["bwd"]["h8_c64"]],
                **{f"segment_softmax_spmm_{w}": [
                    r[w] for case, r in spmm.items()
                    if case.startswith("random")] for w in ("fwd", "bwd")}}
    off_path["segment_softmax_spmm_bwd"].append(kern_srv["gat"]["bwd"])
    # kernel C's backward checked at the serving and viz shapes, which
    # run no backward
    for k in (kern_jax, kern_viz):
        off_path["segment_softmax_spmm_bwd"] += [
            k["set2set"][c]["bwd"] for c in ("light", "set2set")]
    for name, checked in automl["widths"].items():
        off_path[name] += checked

    pair_paths = {"train_ddi": ddi_trained, "train_dti": dti_trained,
                  "train_screening": scr_trained, "serve_dti": dti_served}
    launches = {
        "triplet_fused_fwd": {"serve": served["triplet_fused_fwd"],
                              "train": trained["triplet_fused_fwd"]},
        "triplet_fused_bwd": {"train": trained["triplet_fused_bwd"]},
        "segment_softmax_spmm_fwd": {
            "serve_light_set2set": lib_served["segment_softmax_spmm_fwd"],
            "train_light_set2set": lib_trained["segment_softmax_spmm_fwd"],
            "train_gat_lapool": gat_trained["segment_softmax_spmm_fwd"]},
        "segment_softmax_spmm_bwd": {
            "train_light_set2set": lib_trained["segment_softmax_spmm_bwd"],
            "train_gat_lapool": gat_trained["segment_softmax_spmm_bwd"]}}
    for name, counts in launches.items():
        counts.update({path: n[name] for path, n in pair_paths.items()
                       if path in calls[name]})
    more_paths = {"train_flagship_bf16": bf16_a,
                  "train_library_bf16": bf16_c,
                  "serve_jax_ckpt": jax_served, "viz": viz_launches}
    for name, counts in launches.items():
        counts.update({path: n[name] for path, n in more_paths.items()
                       if path in calls[name]})
    # the AutoML paths: the trials' own training (counted in each trial
    # process), serving each trial's checkpoint and the blend with PASP
    # (this process); each config's calls timed at its trainer's batch
    # (the search) or at the blend's test batch of 32 (the others)
    for path, cfgs in (("automl_search", automl["configs"]),
                       ("automl_trials", automl["configs"]),
                       ("automl_blend", automl["selected"])):
        for name in launches:
            n = automl["launches"][path][name]
            if not n:
                continue
            w = name.rsplit("_", 1)[1]
            triplet = name.startswith("triplet")
            calls[name][path] = {}
            for c in cfgs:
                at = (f"train{c['batch_size']}" if path == "automl_search"
                      else "test32")
                for kind, _, C, k in config_calls(c):
                    if (kind == "triplet") == triplet:
                        calls[name][path][f"{c['note']}_{at}_{kind}_c{C}"] \
                            = (k, automl["at"][f"{at}_{kind}_c{C}"][w])
            launches[name][path] = n
    # a kernel's times are per launch on the path that launches it most:
    # the mean over that path's calls, each weighted by its launches per
    # forward; by_path holds every path's launches, those means and each
    # call's numbers at its own shapes
    pallas = "glam_tpu/ops/pallas"
    meta = {"triplet_fused_fwd": ("triplet_fused.cu",
                                  f"{pallas}/triplet_fused.py:236"),
            "triplet_fused_bwd": ("triplet_fused_bwd.cu",
                                  f"{pallas}/triplet_fused.py:296"),
            "segment_softmax_spmm_fwd": ("segment_softmax_spmm.cu",
                                         f"{pallas}/segment_mxu.py:100"),
            "segment_softmax_spmm_bwd": (
                "segment_softmax_spmm_bwd.cu",
                "glam_tpu/ops/segment.py:50 + glam_tpu/ops/segment.py:21 "
                "(XLA autodiff; the TPU kernel "
                f"{pallas}/segment_mxu.py:100 is forward-only)")}
    kernels = []
    # the parallel layer's paths: every rank's launches; the kernels at
    # a rank's batch (the halo: shard 0's CSR)
    pk = par["kern"]
    for w in ("fwd", "bwd"):
        calls[f"triplet_fused_{w}"]["train_dp"] = {
            "dp_rank_batch": (3, pk["train_dp"][w])}
        calls[f"triplet_fused_{w}"]["train_dp_ddi"] = {
            t: (3, r[w]) for t, r in pk["train_dp_ddi"].items()}
        calls[f"segment_softmax_spmm_{w}"]["train_dp_library"] = {
            c: (3, pk["train_dp_library"][c][w]) for c in ("light",
                                                          "set2set")}
    calls["segment_softmax_spmm_fwd"]["halo"] = {
        "halo_shard0": (1, pk["halo"]["fwd"])}
    off_path["segment_softmax_spmm_bwd"].append(pk["halo"]["bwd"])
    # the sharded paths: A and B at a step's molecule batch or the
    # TripletMessage protein shard's table, C at a GAT shard's
    sk = shd["kern"]
    for w in ("fwd", "bwd"):
        for path in ("train_sharded_dti", "train_sharded_ring"):
            calls[f"triplet_fused_{w}"][path] = {
                "mol_batch": (3, sk[path][w])}
            calls[f"segment_softmax_spmm_{w}"][path] = {
                "gat_shard0": (3, sk[path]["gat"][w])}
        calls[f"triplet_fused_{w}"]["sharded_protein"] = {
            "protein1000_table_shard0": (3, sk["sharded_protein"][w])}
        calls[f"segment_softmax_spmm_{w}"]["sharded_protein"] = {
            "protein1000_gat_shard0": (3, sk["sharded_protein"]["gat"][w])}
        # the giant demo: its molecule tower's batch of 2 pairs
        calls[f"triplet_fused_{w}"]["giant_protein"] = {
            "giant_mol_batch": (3, sk["giant_protein"][w])}
    for path, by_rank in list(par["launches"].items()) \
            + list(shd["launches"].items()):
        for name in launches:
            if path in calls[name]:
                launches[name][path] = sum(r.get(name, 0) for r in by_rank)
    for name, counts in launches.items():
        for path, n in counts.items():
            if n < 1:
                fail(f"{name} never launched on the {path} path")
    for name, (src, replaces) in meta.items():
        counts = launches[name]
        by_path = {path: dict(per_launch(calls[name][path]), launches=n,
                              calls={c: dict(r, launches_per_forward=w)
                                     for c, (w, r) in
                                     calls[name][path].items()})
                   for path, n in counts.items()}
        k = by_path[max(counts, key=counts.get)]
        checked = [r for path in calls[name].values()
                   for _, r in path.values()] + off_path[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"glam_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": sum(counts.values()),
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None, "by_path": by_path,
            "bound_with_row_stats_ms": k["bound_with_row_stats_ms"],
            "device_kernels_per_call": max(
                r["device_kernels"] for r in checked),
            "deterministic": all(r["deterministic"] for r in checked),
        })
    print(json.dumps({"kernels": kernels}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
