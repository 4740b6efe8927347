"""Ranks, their devices and their process group: the counterpart of the
JAX package's ``parallel/distributed.py``.

The JAX package is one process over a ``Mesh`` of devices.  The port is
one process per rank over ``torch.distributed``: every rank runs the same
program on its own device, as the JAX package's hosts each run one
program.  ``initialize_distributed`` wires a rank from the arguments or
the same environment variables (``GLAM_COORDINATOR`` host:port,
``GLAM_NUM_PROCESSES``, ``GLAM_PROCESS_ID``), over ``tcp://``; a rank
takes its share of the host's cores as its threads unless
``OMP_NUM_THREADS`` sets them (a rank on a card too: its host work, the
loaders and the copies into a step graph's static slots, runs on them,
and ranks that each spin every core stall one another).

The backend follows one rule (:func:`backend_for`): ``nccl`` when every
rank on this host has a card of its own, ``gloo`` when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU.  The ranks on a
host are ``GLAM_LOCAL_PROCESSES`` (default: all of the job's), rank r
drives ``cuda:(r % cards)``.  gloo takes CUDA tensors for every
collective the port uses (``all_reduce``, ``broadcast``, ``all_gather``,
``all_to_all_single``: ``scripts/gloo_cuda_probe.py`` on the H100); it
refuses the list ``all_to_all`` and aborts the process on ``send`` and
``recv`` of CUDA tensors, which the port does not call.

What a rank's captured step may hold follows from the backend as well
(:func:`step_graphs_for`, :func:`sharded_step_graphs_for`).  Under
``nccl`` a collective is a kernel on the rank's card, queued on NCCL's
stream, which a capture forks from and joins back to the capturing
stream: a step's collectives go inside its graph ("whole"), the
all-reduce of a data-parallel step, and the halo exchanges
(``all_to_all_single``; the ring plan's ``batch_isend_irecv`` send and
receive), the norms' and readouts' all-reduces and the gradients'
broadcast of a node-sharded one.  Under ``gloo`` no collective can be
captured: gloo copies a CUDA tensor to the host, reduces it there on
its own threads and copies it back.  A data-parallel step then replays
two graphs around one eager all-reduce ("segmented"); a node-sharded
step, whose collectives sit inside autograd's forward and backward,
runs eagerly.  Two rules hold every capture under nccl:

  * the collectives are warm first.  NCCL makes a communicator (and,
    for send and receive, a peer's channels) at the first collective
    that needs it, which a capture cannot do; the eager warm-up of a
    signature (``cuda_graphs.CapturedCalls.warm_up``) issues every
    collective its step issues;
  * NCCL's watchdog thread polls the events of the collectives it
    tracks (``cudaEventQuery``).  A collective issued during a capture
    is not tracked, but the eager ones before it may still be, and a
    capture in ``torch.cuda.graph``'s default "global" mode turns the
    watchdog's query from another thread into an error that spoils the
    capture.  So a capture under nccl runs in "thread_local" mode
    (``CAPTURE_ERROR_MODE``), after a device synchronisation; the
    watchdog stays on and its timeouts hold.

:func:`shutdown` leaves the group, the captured graphs collected
first: an nccl communicator is not destroyed while a graph holding its
collectives lives.

``process_shard`` partitions a dataset over ranks, ``host_groups`` the
visible cards into trial groups, and ``global_mesh`` is the ordered list
of the ranks' devices.  ``spawn_ranks`` and ``wait_ranks`` start the
ranks of one job on this host and wait for them; ``run.py``,
``bench_scaling.py`` and the checks use them.

Differentiable collectives.  JAX differentiates one program over the
mesh; here every rank runs its own backward, so each collective states
what its result feeds.  The rule (Megatron's f and g):

  * :func:`reduce_to_replicated` (g): a shard's partial sum becomes a
    value every rank holds and uses alike (pooled readouts, fusion
    statistics).  Forward all-reduce sum, backward identity: each rank's
    cotangent is already the whole one.
  * :func:`enter_local` (f): a replicated tensor (a parameter, the
    molecule tower's node states) enters shard-local work.  Forward
    identity, backward all-reduce sum: each rank holds only its shard's
    part of the gradient.  It takes many tensors and reduces their
    gradients in one all-reduce.
  * :func:`reduce_to_local` (f after g): a partial sum whose result
    feeds shard-local work again (the norms' statistics).  All-reduce
    sum both ways.
  * :func:`all_to_all_grad`: its transpose is the same exchange of the
    cotangent, which carries the halo rows' gradient back to the shard
    that owns them.
  * :func:`all_gather_replicated`: gathers the shards' rows into a value
    every rank uses alike; backward takes this rank's slice.
    :func:`all_gather_local`: gathers them for shard-local work;
    backward sums the cotangents over the ranks, then takes this rank's
    slice.
  * :func:`ring_shift`: the ring plan's send to rank ``+k``; its
    transpose sends the cotangent back by ``-k``.  Under gloo, which
    aborts the process on send/recv of CUDA tensors, it stages through
    CPU tensors; under nccl it stays on the device.
  * :func:`exchange_start` / :func:`exchange_finish`: either exchange
    split in two, so that work that does not read the received rows runs
    while they travel (``async_op``: under nccl the exchange runs on
    NCCL's stream, and the finish makes the current stream wait for it;
    in a captured graph the two are a fork and a join).  Its backward
    issues the reverse exchange at the finish's node and waits for it at
    the start's, so autograd's nodes made between the two in the forward
    run while it travels.  :func:`all_to_all_grad` and :func:`ring_shift`
    are a start and its finish back to back.
  * :func:`all_reduce_max` takes no gradient (the softmax shifts cancel;
    the fusion max routes its gradient through the owner shard).

Every SUM above, and the data-parallel step's, is :func:`all_reduce_sum`:
an ``all_gather``, then the ranks' terms added in rank order on every
rank, so that a step's bits depend on neither the backend nor NCCL's
choice of algorithm (the JAX package's compiled ``psum`` has one order
too), and a parallel run repeats and resumes bit for bit.

With them, every rank's backward yields the whole gradient of every
parameter, replicated or not, and no replicated parameter's gradient is
summed twice.  :func:`broadcast_` sends rank 0's tensor to the others.
"""
from __future__ import annotations

import datetime
import gc
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


# a rank's captured steps by backend: (design, why)
STEP_GRAPHS = {
    "nccl": ("whole", "nccl runs its collectives as kernels on the "
             "rank's card, so each step's graph holds its all-reduce "
             "(one graph a step, one a group of --scan_steps steps)"),
    "gloo": ("segmented", "gloo stages CUDA tensors through the host, "
             "which no graph can hold, so each step replays two graphs "
             "around one eager all-reduce of the first one's buffer"),
}
# the capture mode of a graph that holds nccl collectives (see the module
# docstring: NCCL's watchdog queries events from its own thread)
CAPTURE_ERROR_MODE = {"nccl": "thread_local", "gloo": "global"}


def step_graphs_for(backend: str, device_type: str = "cuda"
                    ) -> Tuple[Optional[str], str]:
    """(design, why) of a data-parallel rank's captured steps under
    ``backend``: "whole" (nccl), "segmented" (gloo), or None on the
    CPU, which has no CUDA graphs."""
    if device_type != "cuda":
        return None, "a CPU has no CUDA graphs: the steps run eagerly"
    if backend not in STEP_GRAPHS:
        raise ValueError(f"no step graphs for backend {backend!r}")
    return STEP_GRAPHS[backend]


def sharded_step_graphs_for(backend: str, device_type: str = "cuda"
                            ) -> Tuple[Optional[str], str]:
    """(design, why) of a node-sharded rank's captured steps: "whole"
    under nccl; None under gloo, whose collectives inside autograd's
    forward and backward leave no place for an eager one between two
    graphs, and on the CPU."""
    if device_type != "cuda":
        return None, "a CPU has no CUDA graphs: the steps run eagerly"
    if backend == "nccl":
        return "whole", ("nccl runs the halo exchanges, the norms' and "
                         "readouts' all-reduces and the gradients' "
                         "broadcast as kernels on the rank's card, so "
                         "each step's graph holds them")
    return None, ("gloo stages the halo exchanges and the norms' "
                  "collectives through the host, inside autograd's "
                  "forward and backward, where no graph can hold them: "
                  "the steps run eagerly")


def step_graphs_rule(device_type: str, local_processes: int,
                     device_count: int) -> Tuple[str, Optional[str], str]:
    """(backend, data-parallel design, why) for ranks placed as
    :func:`backend_for` places them."""
    backend, _ = backend_for(device_type, local_processes, device_count)
    return (backend,) + step_graphs_for(backend, device_type)


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
    if "OMP_NUM_THREADS" not in os.environ:
        # the host's cores shared among its ranks: a rank with all of
        # them spins its threads while another waits for it
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=TIMEOUT)
    if rank == 0:
        print(f"[distributed] {world} ranks, backend {backend}: {why}",
              flush=True)
    return backend


def shutdown() -> None:
    """Leave the process group: every rank alike, after the others
    (a barrier).  An nccl communicator's destruction waits until every
    CUDA graph that holds its collectives is destroyed, so the graphs
    go first: the caller drops its references to them (a trainer, its
    step graphs), and unreachable ones still held in reference cycles
    (a trainer's step graphs hold its steps, which hold the trainer) are
    collected here, their last replays synchronised; otherwise every
    rank hangs here."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()


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
def _gathered(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t``, in rank order (one ``all_gather``)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[ranks, *t.shape]: every rank's ``t`` in rank order."""
    return torch.stack(_gathered(t, group))


def all_to_all(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` [ranks, ...] sends t[d] to rank d; returns [ranks, ...] whose
    row s is what rank s sent here (JAX's ``all_to_all`` with split and
    concat axis 0, untiled)."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks in rank order, in place: one
    ``all_gather`` of every rank's ``t``, then ((r0 + r1) + r2) + ...,
    left to right, on every rank.  Every rank computes the same bits,
    whatever the backend, its algorithm or its channel count (an
    ``all_reduce``'s order of terms is NCCL's tuner's choice past 2
    ranks); at 2 ranks it is ``all_reduce``'s r0 + r1.  Every SUM
    reduction of the parallel layer goes through it; a graph under nccl
    may capture it."""
    parts = _gathered(t, group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return t.copy_(total)


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over the ranks of ``t``, detached (no
    gradient)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    dist.broadcast(t, src, group=group)
    return t


class _ReduceToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _EnterLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.clone() for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        parts = [g.reshape(-1) if g is not None else
                 torch.zeros(shape.numel(), dtype=dtype, device=device)
                 for g, (shape, dtype, device) in zip(gs, ctx.shapes)]
        flat = all_reduce_sum(torch.cat(parts), ctx.group)
        out, at = [], 0
        for shape, _, _ in ctx.shapes:
            out.append(flat[at:at + shape.numel()].view(shape))
            at += shape.numel()
        return (None, *out)


def reduce_to_replicated(t: torch.Tensor, group=None) -> torch.Tensor:
    """g: all-reduce sum forward, identity backward (the result feeds
    work every rank does alike)."""
    return _ReduceToReplicated.apply(t, group)


def reduce_to_local(t: torch.Tensor, group=None) -> torch.Tensor:
    """f after g: all-reduce sum forward and backward (the result feeds
    shard-local work)."""
    return _ReduceToLocal.apply(t, group)


def enter_local(*ts: torch.Tensor, group=None):
    """f: the replicated tensors ``ts`` as they enter shard-local work;
    identity forward, one all-reduce sum of all their gradients backward.
    Returns a tuple."""
    return _EnterLocal.apply(group, *ts)


def all_to_all_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`all_to_all`, differentiable: the backward sends each row of
    the cotangent back to the rank it came from."""
    return exchange_finish(exchange_start([t], None, group))[0]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, local, group):
        ctx.local, ctx.group = local, group
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.local:
            g = all_reduce_sum(g.clone(), ctx.group)
        return g[dist.get_rank(ctx.group)], None, None


def all_gather_replicated(t: torch.Tensor, group=None) -> torch.Tensor:
    """[ranks, *t.shape] for work every rank does alike; backward takes
    this rank's slice of the cotangent."""
    return _AllGather.apply(t, False, group)


def all_gather_local(t: torch.Tensor, group=None) -> torch.Tensor:
    """[ranks, *t.shape] for shard-local work; backward sums the
    cotangents over the ranks and takes this rank's slice."""
    return _AllGather.apply(t, True, group)


def ring_shift(t: torch.Tensor, k: int, group=None) -> torch.Tensor:
    """The ring plan's permute at distance ``k``, differentiable: rows
    from rank (r - k) % D; the backward sends the cotangent back."""
    return exchange_finish(exchange_start([t], [k], group))[0]


# ------------------------------------------------ the split halo exchange
class Flight:
    """One exchange in flight each way (see :func:`exchange_start`):
    ``ks`` the ring distances (None: one all_to_all), ``fwd`` and
    ``bwd`` the issued forward and backward exchange, each (receive
    buffers, requests, the send buffers kept until the wait, whether
    they are staged through the CPU, the device); ``blocking``: each is
    waited for where it is issued."""

    def __init__(self, ks: Optional[Sequence[int]], group, blocking: bool):
        self.ks, self.group, self.blocking = ks, group, blocking
        self.fwd = self.bwd = None

    def issue(self, sends, ks):
        issued = _issue(sends, ks, self.group)
        if self.blocking:
            issued = (_wait(issued), [], [], False, None)
        return issued


def _issue(sends: Sequence[torch.Tensor], ks, group):
    """Issue one exchange of ``sends`` without waiting for it: one
    ``all_to_all_single`` of sends[0] [ranks, ...] (``ks`` None), or one
    ``batch_isend_irecv`` sending sends[i] to rank (r + ks[i]) % D and
    receiving its shape from (r - ks[i]) % D.  The ring's CUDA tensors
    are staged through the CPU under gloo, which aborts the process on
    send and receive of CUDA tensors."""
    device = sends[0].device
    if ks is None:
        send = sends[0].contiguous()
        recv = torch.empty_like(send)
        req = dist.all_to_all_single(recv, send, group=group, async_op=True)
        return [recv], [req], [send], False, device
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    stage = device.type == "cuda" and dist.get_backend(group) == "gloo"
    send = [(t.cpu() if stage else t).contiguous() for t in sends]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for k, snd, rcv in zip(ks, send, recv):
        ops += [dist.P2POp(dist.isend, snd, (rank + k) % n, group),
                dist.P2POp(dist.irecv, rcv, (rank - k) % n, group)]
    return recv, dist.batch_isend_irecv(ops), send, stage, device


def _wait(issued) -> List[torch.Tensor]:
    """Wait for an issued exchange: the current stream waits for the
    communication (nccl), or the host for it (gloo); then its send
    buffers are let go.  The received tensors, on the senders' device."""
    recv, reqs, _, stage, device = issued
    for req in reqs:
        req.wait()
    return [r.to(device) for r in recv] if stage else recv


class _ExchangeStart(torch.autograd.Function):
    """Issues the forward exchange; returns an empty token that orders
    :class:`_ExchangeFinish` after it.  Its backward waits for the
    backward exchange that the finish's backward issued."""

    @staticmethod
    def forward(ctx, flight, *sends):
        ctx.flight = flight
        flight.fwd = flight.issue(sends, flight.ks)
        return sends[0].new_empty(0)

    @staticmethod
    def backward(ctx, _):
        flight = ctx.flight
        grads = _wait(flight.bwd)
        flight.bwd = None
        return (None, *grads)


class _ExchangeFinish(torch.autograd.Function):
    """Waits for the forward exchange; its backward issues the reverse
    one (the cotangents back to the ranks their rows came from)."""

    @staticmethod
    def forward(ctx, flight, token):
        ctx.flight = flight
        recv = _wait(flight.fwd)
        flight.fwd = None
        return tuple(recv)

    @staticmethod
    def backward(ctx, *grads):
        flight = ctx.flight
        back = None if flight.ks is None else [-k for k in flight.ks]
        flight.bwd = flight.issue([g.contiguous() for g in grads], back)
        return None, grads[0].new_empty(0)


def exchange_start(sends: Sequence[torch.Tensor], ks=None, group=None,
                   blocking: bool = False) -> Tuple[Flight, torch.Tensor]:
    """Issue a halo exchange and return at once: one ``all_to_all`` of
    sends[0] [ranks, ...] (``ks`` None: row d goes to rank d), or the
    ring plan's sends, sends[i] to rank (r + ks[i]) % D, in one
    ``batch_isend_irecv``.  Under nccl the exchange runs on NCCL's stream
    while the current stream goes on (in a captured graph, a branch
    beside the work issued before :func:`exchange_finish`).  Pass the
    result to :func:`exchange_finish`.  Differentiable: the backward
    issues the reverse exchange where the finish's backward runs and
    waits for it where the start's does, so that autograd's work between
    the two overlaps it.  The send buffers stay referenced until each
    wait, so that the allocator does not hand them out while the
    exchange reads them.  Issue no other collective between a start and
    its finish, either way: two NCCL operations in flight on two
    communicators can deadlock.  ``blocking``: each way, wait where the
    exchange is issued (the autograd graph stays the same)."""
    flight = Flight(None if ks is None else list(ks), group, blocking)
    return flight, _ExchangeStart.apply(flight, *sends)


def exchange_finish(started: Tuple[Flight, torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Wait for :func:`exchange_start`'s exchange: the received tensors,
    one a send (``all_to_all``: [ranks, ...], row s from rank s; ring:
    sends[i]'s shape, from rank (r - ks[i]) % D)."""
    return list(_ExchangeFinish.apply(*started))
