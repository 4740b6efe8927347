"""Ranks, their devices and their process group: the counterpart of the
JAX package's ``parallel/distributed.py``.

The JAX package is one process over a ``Mesh`` of devices.  The port is
one process per rank over ``torch.distributed``: every rank runs the same
program on its own device, as the JAX package's hosts each run one
program.  ``initialize_distributed`` wires a rank from the arguments or
the same environment variables (``GLAM_COORDINATOR`` host:port,
``GLAM_NUM_PROCESSES``, ``GLAM_PROCESS_ID``), over ``tcp://``.

The backend follows one rule (:func:`backend_for`): ``nccl`` when every
rank on this host has a card of its own, ``gloo`` when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU.  The ranks on a
host are ``GLAM_LOCAL_PROCESSES`` (default: all of the job's), rank r
drives ``cuda:(r % cards)``.  gloo takes CUDA tensors for every
collective the port uses (``all_reduce``, ``broadcast``, ``all_gather``,
``all_to_all_single``: ``scripts/gloo_cuda_probe.py`` on the H100); it
refuses the list ``all_to_all`` and aborts the process on ``send`` and
``recv`` of CUDA tensors, which the port does not call.

``process_shard`` partitions a dataset over ranks, ``host_groups`` the
visible cards into trial groups, and ``global_mesh`` is the ordered list
of the ranks' devices.  ``spawn_ranks`` and ``wait_ranks`` start the
ranks of one job on this host and wait for them; ``run.py``,
``bench_scaling.py`` and the checks use them.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV_COORDINATOR = "GLAM_COORDINATOR"
ENV_NUM_PROCESSES = "GLAM_NUM_PROCESSES"
ENV_PROCESS_ID = "GLAM_PROCESS_ID"
ENV_LOCAL_PROCESSES = "GLAM_LOCAL_PROCESSES"
# how long a rank waits at the rendezvous and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(rank: int, platform: str = "cuda") -> torch.device:
    """Rank ``rank``'s device: ``cpu`` for platform ``cpu``, else
    ``cuda:(rank % cards)``; raises when no card is visible."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"platform {platform!r}: use 'cpu' or 'cuda'")
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError(f"rank {rank} asked for a card, but no CUDA "
                           "device is available")
    return torch.device(f"cuda:{rank % count}")


def backend_for(device_type: str, local_processes: int,
                device_count: int) -> Tuple[str, str]:
    """(backend, reason) for ranks on ``device_type`` with
    ``local_processes`` ranks on this host and ``device_count`` cards."""
    if device_type != "cuda":
        return "gloo", "the ranks run on the CPU"
    if local_processes <= device_count:
        return "nccl", (f"each of the {local_processes} ranks on this host "
                        f"has a card of its own ({device_count} visible)")
    return "gloo", (f"{local_processes} ranks share {device_count} card(s) "
                    "on this host, and NCCL refuses two ranks on one GPU")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           platform: str = "cuda") -> str:
    """Join the process group as rank ``process_id`` of
    ``num_processes``, over ``tcp://<coordinator_address>``; each
    argument left out is read from its ``GLAM_*`` variable.  Makes the
    rank's device current; rank 0 prints the backend and why.  Returns
    the backend."""
    addr = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if not addr:
        raise ValueError(f"no coordinator: pass coordinator_address or set "
                         f"{ENV_COORDINATOR}=host:port")
    world = int(num_processes if num_processes is not None
                else os.environ[ENV_NUM_PROCESSES])
    # `or` would take rank 0 for missing
    rank = int(process_id if process_id is not None
               else os.environ[ENV_PROCESS_ID])
    device = rank_device(rank, platform)
    local = int(os.environ.get(ENV_LOCAL_PROCESSES, world))
    backend, why = backend_for(
        device.type, local,
        torch.cuda.device_count() if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=TIMEOUT)
    if rank == 0:
        print(f"[distributed] {world} ranks, backend {backend}: {why}",
              flush=True)
    return backend


def world() -> Tuple[int, int]:
    """(rank, number of ranks) of this process; (0, 1) outside a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis_names=("data",), shape=None,
                platform: str = "cuda") -> List[torch.device]:
    """The ranks' devices in rank order (the JAX package's mesh over every
    device of the job); ``shape`` must multiply out to the rank count.
    ``axis_names`` is taken for the JAX signature: the port's axes are
    its process groups."""
    del axis_names
    _, n = world()
    devices = [rank_device(r, platform) for r in range(n)]
    if shape is not None and int(torch.tensor(shape).prod()) != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} ranks")
    return devices


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> List:
    """Partition a dataset across ranks (each loads its share): item i
    goes to rank i % count."""
    rank, n = world()
    pi = rank if process_index is None else process_index
    pc = n if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pc == pi]


def host_groups(n_groups: int, devices: Optional[Sequence] = None
                ) -> List[List]:
    """Partition the visible cards (or ``devices``) into ``n_groups``
    contiguous trial groups."""
    if devices is None:
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_groups <= 0 or n_groups > len(devices):
        raise ValueError(f"bad n_groups {n_groups} for {len(devices)} "
                         "devices")
    per = len(devices) // n_groups
    return [devices[i * per:(i + 1) * per] for i in range(n_groups)]


def free_port() -> int:
    """A TCP port free on this host now, for a job's coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: Sequence[str], n: int, logs=None
                ) -> List[subprocess.Popen]:
    """Start ``n`` processes of ``cmd`` as the ranks of one job on this
    host: each with the ``GLAM_*`` variables set, its coordinator on a
    free local port.  ``logs``: a directory that takes rank k's output
    as ``rank<k>.out`` (default: this process's)."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, **{
            ENV_COORDINATOR: f"127.0.0.1:{port}", ENV_NUM_PROCESSES: str(n),
            ENV_PROCESS_ID: str(rank), ENV_LOCAL_PROCESSES: str(n)})
        log = None if logs is None else open(Path(logs) / f"rank{rank}.out",
                                             "w")
        procs.append(subprocess.Popen(
            list(cmd), env=env, stdout=log,
            stderr=None if log is None else subprocess.STDOUT))
        if log is not None:
            log.close()              # the rank holds its own descriptor
    return procs


def wait_ranks(procs: Sequence[subprocess.Popen],
               timeout: Optional[float] = None) -> int:
    """Wait for every rank.  The first to exit nonzero stops the others,
    and so does ``timeout`` seconds passing (then ``TimeoutError``).
    Returns the first nonzero exit code, else 0."""
    def failed():
        return next((p.returncode for p in procs
                     if p.poll() not in (None, 0)), 0)

    end = None if timeout is None else time.monotonic() + timeout
    try:
        while not failed() and any(p.poll() is None for p in procs):
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"the ranks ran past {timeout} s")
            time.sleep(0.2)
        return failed()
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ---------------------------------------------------------- collectives
def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[ranks, *t.shape]: every rank's ``t`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` [ranks, ...] sends t[d] to rank d; returns [ranks, ...] whose
    row s is what rank s sent here (JAX's ``all_to_all`` with split and
    concat axis 0, untiled)."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t
