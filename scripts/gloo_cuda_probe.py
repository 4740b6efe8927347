"""Which ``torch.distributed`` collectives the gloo backend takes on CUDA
tensors, with two ranks on one card.

    python scripts/gloo_cuda_probe.py [--device cuda:0]

NCCL refuses two ranks on one GPU, so the port's ranks that share a card
talk through gloo (``glam_tpu_torch/parallel/distributed.py``), which
calls only collectives this script finds gloo takes on CUDA tensors.  For
each collective the port's data parallelism and halo steps might use,
two fresh rank processes of this script (``distributed.spawn_ranks``)
hold tensors on ``--device`` and call it; each line says whether gloo
took the CUDA tensors and gave the right result, raised, or aborted the
processes (gloo aborts, for one, when it writes a device pointer to its
socket).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from glam_tpu_torch.parallel import distributed  # noqa: E402


def _probe(device, which, out):
    """One rank of the probe of ``which``, from the ``GLAM_*``
    variables; rank 0 writes the verdict to ``out``."""
    rank = int(os.environ[distributed.ENV_PROCESS_ID])
    world = int(os.environ[distributed.ENV_NUM_PROCESSES])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ[distributed.ENV_COORDINATOR]}",
        world_size=world, rank=rank)
    dev = torch.device(device)
    base = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    want_sum = sum(torch.arange(4.0) + 10 * r for r in range(world))

    def all_reduce():
        t = base.clone()
        dist.all_reduce(t)
        return torch.equal(t.cpu(), want_sum)

    def broadcast():
        t = base.clone()
        dist.broadcast(t, 0)
        return torch.equal(t.cpu(), torch.arange(4.0))

    def all_gather():
        ts = [torch.empty_like(base) for _ in range(world)]
        dist.all_gather(ts, base)
        return all(torch.equal(t.cpu(), torch.arange(4.0) + 10 * r)
                   for r, t in enumerate(ts))

    def all_gather_into_tensor():
        t = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(t, base)
        return torch.equal(t.cpu(), torch.cat(
            [torch.arange(4.0) + 10 * r for r in range(world)]))

    def all_to_all_single():
        t = torch.empty_like(base)
        dist.all_to_all_single(t, base)
        return t.shape == base.shape

    def all_to_all():
        ins = list(base.chunk(world))
        outs = [torch.empty_like(x) for x in ins]
        dist.all_to_all(outs, ins)
        return all(o.shape == i.shape for o, i in zip(outs, ins))

    def send_recv():
        t = base.clone()
        if rank == 0:
            dist.send(t, 1)
            return True
        dist.recv(t, 0)
        return torch.equal(t.cpu(), torch.arange(4.0))

    def barrier():
        dist.barrier()
        return True

    fn = locals()[which]
    try:
        verdict = "right" if fn() else "wrong"
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except Exception as err:   # the probe's finding, not a fallback
        verdict = (f"raised {type(err).__name__}: "
                   f"{str(err).splitlines()[0][:120]}")
    if rank == 0:
        with open(out, "w") as f:
            json.dump(verdict, f)
    dist.destroy_process_group()


COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "all_to_all_single", "all_to_all",
               "send_recv", "barrier")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--rank_of", default=None,
                   help="run as a rank of this collective's probe")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.rank_of:
        return _probe(args.device, args.rank_of, args.out)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in COLLECTIVES:
            out = os.path.join(tmp, f"{which}.json")
            rc = distributed.wait_ranks(distributed.spawn_ranks(
                [sys.executable, os.path.abspath(__file__), "--device",
                 args.device, "--rank_of", which, "--out", out], 2,
                logs=tmp), timeout=120)
            if rc:
                last = open(os.path.join(tmp, "rank0.out")).read().strip()
                results[which] = (f"aborted the ranks (exit {rc}): "
                                  + (last.splitlines() or [""])[-1][:160])
            else:
                with open(out) as f:
                    results[which] = json.load(f)
    print(f"torch {torch.__version__}, gloo, 2 ranks on {args.device}:")
    for name, verdict in results.items():
        print(f"  {name}: {verdict}")
    return results


if __name__ == "__main__":
    main()
