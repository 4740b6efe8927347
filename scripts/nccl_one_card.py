#!/usr/bin/env python3
"""The nccl step graphs on one card: one process as a process group of one
nccl rank, so that the "whole" design (a step's collectives inside its
CUDA graph) runs where no second card is:

    python scripts/nccl_one_card.py

Needs one CUDA card.  Prints the card's name and power limit first, then:
  1. a data-parallel rank's steps through ``RankStepGraphs`` in the whole
     design at S = 4 (a group of 4 eagerly, the warm-up; one replay of
     the 4-step graph with its 4 all-reduces; 3 one-step replays, the
     learning rate cut before them) against the same steps eagerly from
     one state: the flagship at full width with Adam, RReLU and Dropout,
     each step's noise reseeded as a rank reseeds it
     (``chip_smoke.hold_bitwise``: the state and the losses bitwise
     equal, launches equal); and the evaluation step's replays against
     eager, bitwise;
  2. the data-parallel flagship step of the smoke's one-step parity
     (batch 64, SGD, no noise) eager and replayed (whole, one step) in
     turns: host ms (medians of 20), the profiles' busy ms and idle
     share, and the gradients' all-reduce ms;
  3. the ring plan's shift (``batch_isend_irecv``) captured in a graph,
     forward and backward, against eager: a send and receive to itself;
  4. the 1,000-residue protein's sharded pair step captured whole
     (``tests/torch_port_dp_worker.py`` task ``sharded_graphs``, a2a and
     ring, GAT and TripletMessage protein towers) against the dense model
     (output rtol/atol 1e-4, gradients rtol 2e-4 + atol 5e-5 x scale),
     the launches of a replay, and its host ms eager and replayed in
     turns with the busy ms;
  5. the sharded DTI trainer at one shard on 60 training pairs of
     dti_demo (the CLI's defaults: RReLU, Dropout, Adam): its replayed
     steps against three eager runs, each step's loss within 1e-4 + twice
     the eager runs' spread.
A single rank has no peer: its collectives are copies, and no number
here is a scaling number.  Exits non-zero on a failed check.
"""
from __future__ import annotations

import itertools
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# (first, last) items of each dispatch; "lr" cuts the learning rate
PLAN = [(0, 4, True), (4, 8, True), "lr", (8, 11, False)]


def dp_whole(tmp, dev, card, cs, worker, torch):
    """Item 1 of the module docstring."""
    from glam_tpu_torch.ops.kernels import launch_counts
    from glam_tpu_torch.parallel import data_parallel, distributed
    from glam_tpu_torch.train.optim import (get_learning_rate,
                                            set_learning_rate)
    from glam_tpu_torch.train.step_graph import RankStepGraphs
    args = dict(cs.DP_GRAPH_CONFIGS["flagship_adam_noise"])
    root = cs.demo_root(tmp)
    seeds = list(range(100, 111))
    runs, evals = {}, {}
    for run in ("eager", "captured"):
        tr = worker.trainer("nccl1", 1, Path(tmp), dev, args, root)
        tr.model.train()
        weight = tr._make_weight()
        step = data_parallel.make_dp_train_step(
            tr.model, tr.loss_fn, tr.optimizer, weight_fn=weight,
            forward=tr.forward)
        ev = data_parallel.make_dp_eval_step(tr.model, tr.loss_fn,
                                             weight_fn=weight,
                                             forward=tr.forward)
        host = [tr._as_parts(h) for h in itertools.islice(
            itertools.cycle(tr.train_loader), 11)]
        valid = [tr._as_parts(h) for h in itertools.islice(
            tr.valid_loader, 2)]
        graphs = RankStepGraphs(step, ev, dev, tr.generator, "whole", 4,
                                distributed.CAPTURE_ERROR_MODE["nccl"])
        before = launch_counts()
        losses = []
        for part in PLAN:
            if part == "lr":
                set_learning_rate(tr.optimizer,
                                  0.7 * get_learning_rate(tr.optimizer))
                continue
            a, b, stack = part
            if run == "captured":
                losses.append(graphs.train(host[a:b], stack, seeds[a:b]))
                continue
            for item, seed in zip(host[a:b], seeds[a:b]):
                tr.generator.manual_seed(seed)
                losses.append(step(tuple(p.to(dev) for p in item),
                                   tr.generator)[None])
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        tr.model.eval()
        with torch.inference_mode():
            if run == "captured":
                evals[run] = [graphs.evaluate(valid, False)[1]
                              for _ in range(3)]
            else:
                evals[run] = [torch.stack([ev(tuple(
                    p.to(dev) for p in item))[1] for item in valid])]
        state = {k: v.detach().cpu().clone()
                 for k, v in tr.model.state_dict().items()}
        state.update({f"{i}.{k}": v.detach().cpu().clone()
                      for i, st in enumerate(tr.optimizer.state.values())
                      for k, v in st.items() if torch.is_tensor(v)})
        runs[run] = (state, torch.cat(losses).cpu(), launches,
                     dict(graphs.stats) if run == "captured" else None,
                     get_learning_rate(tr.optimizer))
    cs.hold_bitwise("nccl1 dp whole S=4", "Adam", True, PLAN, runs, card)
    eager = evals["eager"][0]
    if not all(torch.equal(e, eager) for e in evals["captured"]):
        gap = max(float((e - eager).abs().max()) for e in evals["captured"])
        cs.fail(f"nccl1 dp whole: evaluation replays {gap:.3e} from eager")
    print(f"nccl1 dp whole evaluation: 3 replays of 2 batches bitwise "
          f"equal to eager ({card})")


def dp_turns(tmp, dev, card, cs, worker, torch):
    """Item 2 of the module docstring."""
    from glam_tpu_torch.parallel import data_parallel, distributed
    from glam_tpu_torch.train.step_graph import RankStepGraphs
    tr = worker.trainer("nccl1_turns", 1, Path(tmp), dev, cs.DP_STEP_ARGS,
                        cs.demo_root(tmp))
    tr.model.train()
    step_obj = data_parallel.make_dp_train_step(
        tr.model, tr.loss_fn, tr.optimizer, weight_fn=tr._make_weight(),
        forward=tr.forward)
    batch = tr._to_device(next(iter(tr.train_loader)))
    step = lambda: step_obj(batch, tr.generator)  # noqa: E731
    for _ in range(3):
        step()
    graphs = RankStepGraphs(step_obj, None, dev, tr.generator, "whole", 1,
                            distributed.CAPTURE_ERROR_MODE["nccl"])
    host = tuple(p.to("cpu") for p in batch)
    seeds = iter(range(1 << 30))
    replay = lambda: graphs.train([host], False, [next(seeds)])  # noqa
    replay()                  # the warm-up, eagerly; then the capture
    replay()
    turns = {"eager": [], "replayed": []}
    for _ in range(2):
        turns["eager"].append(worker._median_ms(step))
        turns["replayed"].append(worker._median_ms(replay))
    busy = worker._profile("nccl1 dp step eager", step)
    busy_r = worker._profile("nccl1 dp step replayed", replay)
    flat = torch.zeros(sum(p.numel() for p in tr.model.parameters()),
                       device=dev)
    ar = worker._median_ms(lambda: distributed.all_reduce_sum(flat))
    he, hr = (statistics.median(turns[t]) for t in ("eager", "replayed"))
    print(f"nccl1 dp step [flagship, batch 64, SGD, whole]: host ms in "
          f"turns eager {', '.join(f'{v:.4f}' for v in turns['eager'])}, "
          f"replayed {', '.join(f'{v:.4f}' for v in turns['replayed'])}; "
          f"busy ms eager {busy['busy_ms']:.4f}, replayed "
          f"{busy_r['busy_ms']:.4f}; idle share eager "
          f"{1 - busy['busy_ms'] / he:.3f}, replayed "
          f"{1 - busy_r['busy_ms'] / hr:.3f}; all_reduce of "
          f"{flat.numel()} floats {ar:.4f} ms (one rank: a copy) ({card})")


def ring_capture(dev, cs, torch):
    """Item 3 of the module docstring."""
    from glam_tpu_torch.cuda_graphs import CapturedCalls
    from glam_tpu_torch.parallel import distributed
    x = torch.randn(64, 180, device=dev, requires_grad=True)
    w = torch.randn(64, 180, device=dev)

    def body():
        x.grad = None
        y = distributed.ring_shift(x * 2.0, 1)
        (y * w).sum().backward()
        return y.detach(), x.grad

    calls = CapturedCalls(dev)
    calls.capture_error_mode = distributed.CAPTURE_ERROR_MODE["nccl"]
    eager = [t.clone() for t in calls.warm_up(body)]
    graph = calls.capture(body)
    got = calls.replay(graph)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, eager)):
        cs.fail("nccl1 ring shift: the replay differs from eager")
    print("nccl1 ring shift (batch_isend_irecv to itself) captured "
          "forward and backward: the replay equals eager bitwise")


def sharded_step(tmp, dev, card, cs, worker, torch):
    """Item 4 of the module docstring."""
    cases = cs.sharded_protein_cases()
    torch.save(cases, Path(tmp) / "sharded.pt")
    got = worker.task_sharded_graphs(Path(tmp), {}, dev)["sharded_graphs"][0]
    dense = {n: cs.dense_pair_reference(c, dev) for n, c in cases.items()}
    for key, r in got.items():
        name = next(c for c in cases if key.startswith(c))
        out_err, grad_err = cs.hold_sharded(f"nccl1 {key}", r, *dense[name])
        a = 6 if name.endswith("_TripletMessage") else 3
        c = 3 if name.endswith("_GATConv") else 0
        cs.check_counts(f"nccl1 {key}", r["launches"], {
            "triplet_fused_fwd": a, "triplet_fused_bwd": a,
            "segment_softmax_spmm_fwd": c, "segment_softmax_spmm_bwd": c,
            "segment_sum_csr": cs.csr_want(
                cases[name]["cfg"], 1, 1, hetero=True, sharded_protein=True,
                sends=r["sends"])})
        be, br = r["busy"], r["busy_replayed"]
        he, hr = (statistics.median(r["turns"][x])
                  for x in ("eager", "replayed"))
        print(f"nccl1 sharded step [{key}] captured whole: output within "
              f"{out_err:.3e} of dense, gradients within {grad_err:.3e} of "
              f"each leaf's scale; launches at replay exact (A {a}, B {a}, "
              f"C {c}); host ms in turns eager "
              f"{', '.join(f'{v:.4f}' for v in r['turns']['eager'])}, "
              f"replayed "
              f"{', '.join(f'{v:.4f}' for v in r['turns']['replayed'])}; "
              f"busy ms eager {be['busy_ms']:.4f} (without collectives' "
              f"kernels {be['busy_own_ms']:.4f}), replayed "
              f"{br['busy_ms']:.4f}; idle share eager "
              f"{1 - be['busy_ms'] / he:.3f}, replayed "
              f"{1 - br['busy_ms'] / hr:.3f} ({card})")


def sharded_trainer(tmp, dev, card, cs, torch):
    """Item 5 of the module docstring."""
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.run import build_parser
    from glam_tpu_torch.train.sharded_pair_trainer import ShardedPairTrainer
    losses, seconds, stats = {}, {}, None
    for run in ("eager", "captured", "eager_2", "eager_3"):
        args = vars(build_parser().parse_args([
            "--dataset", "bindingdb_c", "--dataset_root",
            str(ROOT / "datasets" / "dti_demo"), "--epochs", "1",
            "--mol_block", "_TripletMessage", "--pro_block", "_GATConv"]))
        args["pro_shards"] = 1
        args, ds, kind = auto_dataset(args)
        tr = ShardedPairTrainer(args, ds, task=kind,
                                work_dir=str(Path(tmp) / run), device=dev)
        if run != "captured":
            tr.step_graphs = None
        order = range(60)
        t0 = time.perf_counter()
        got = [tr.train_step(tr._item([tr.splits["train"][i]], train=True))
               for i in order]
        losses[run] = torch.stack(got).cpu()
        seconds[run] = time.perf_counter() - t0
        if run == "captured":
            stats = dict(tr.step_graphs.stats)

    def apart(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    eager = losses["eager"]
    gap = apart(losses["captured"], eager)
    spread = max(apart(losses[r], eager) for r in ("eager_2", "eager_3"))
    if gap > 1e-4 + 2 * spread:
        cs.fail(f"nccl1 sharded trainer: replayed losses {gap:.3e} from "
                f"eager (eager runs {spread:.3e} apart)")
    print(f"nccl1 sharded trainer [dti_demo, 1 shard, 60 steps, RReLU + "
          f"Dropout, Adam]: replayed losses within {gap:.3e} of eager "
          f"(eager runs {spread:.3e} apart; tol 1e-4 + 2 x that); seconds "
          f"eager {seconds['eager']:.3f}, replayed {seconds['captured']:.3f}"
          f" (its warm-up and capture included); {stats['captures']} "
          f"captures, {stats['replays']} replays ({card})")


def main():
    import torch

    import chip_smoke as cs
    import torch_port_dp_worker as worker
    from glam_tpu_torch.ops.kernels import build
    from glam_tpu_torch.parallel import distributed
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    distributed.initialize_distributed(
        f"127.0.0.1:{distributed.free_port()}", 1, 0)
    dev = torch.device("cuda:0")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dp_whole(tmp, dev, card, cs, worker, torch)
            dp_turns(tmp, dev, card, cs, worker, torch)
            ring_capture(dev, cs, torch)
            sharded_step(tmp, dev, card, cs, worker, torch)
            sharded_trainer(tmp, dev, card, cs, torch)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
