"""Fixed-order segment sums over a CSR: the CUDA kernel, its plain torch
version and the two ``autograd.Function``s that use it.

For a CSR of S segments over a slot array, ``rowptr`` [S+1] and the
entry of each slot ``perm`` (int32; None for the identity), and an
optional ``limit`` (a one-element int32 tensor on the device: every row
ends there, and no slot at or past it is read)::

    out[s] = sum_{k = rowptr[s]}^{min(rowptr[s+1], limit)-1} x[perm[k]]

The kernel (``glam_tpu_torch/csrc/segment_sum_csr.cu``) replaces no TPU
kernel: the JAX package's ``jax.ops.segment_sum`` is XLA's, whose order
is fixed by the compiled program, where ``index_add_`` on the card adds
with float atomics in another order on every call.  It sums each segment
in an order fixed by the row pointers, in float32 for bfloat16 and
float16 rows, and writes every output row (no fill): the same bits on
every call.  One launch a call: short segments a warp each, long ones
summed across a thread-block cluster.

  csr_segment_sum  the sum, differentiable: kernel forward, gather
                   backward (``index_select`` by each entry's segment)
  gather_rows      ``x.index_select(0, ids)``, differentiable: its
                   backward sums the rows of each id with the kernel,
                   over the CSR that groups the ids

CPU tensors run :func:`segment_sum_csr_plain`; CUDA tensors the kernel
or raise.  ``segment_sum_csr.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, common

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segment_sum_csr_plain(x, rowptr, perm=None, n=None, limit=None):
    """The kernel's function in plain torch: ``index_add_`` of the listed
    rows (the CPU adds them in slot order), in float32 for a bfloat16 or
    float16 ``x``, rounded once to ``x``'s dtype.  With ``limit`` the row
    pointers are clamped to it first.  ``n``, the listed slots, is read
    from the (clamped) ``rowptr[-1]`` when None (a host read, free on the
    CPU)."""
    if limit is not None:
        rowptr = rowptr.clamp(max=limit)
    n = int(rowptr[-1]) if n is None else n
    rows = torch.repeat_interleave(
        torch.arange(rowptr.shape[0] - 1, device=x.device),
        (rowptr[1:] - rowptr[:-1]).long(), output_size=n)
    picked = x[:n] if perm is None else x.index_select(0, perm[:n].long())
    wide = picked.float() if x.dtype in (torch.float16,
                                         torch.bfloat16) else picked
    out = wide.new_zeros((rowptr.shape[0] - 1,) + tuple(x.shape[1:]))
    return out.index_add_(0, rows, wide).to(x.dtype)


@functools.cache
def _bind():
    lib = build.load("segment_sum_csr")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.segment_sum_csr
    fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    fn.restype = i32
    return fn


@functools.cache
def constants():
    """The kernel's constants: {'cluster': blocks a cluster, 'span': the
    most slots one cluster sums, 'probe': slots between probes}."""
    lib = build.load("segment_sum_csr")
    out = {}
    for key in ("cluster", "span", "probe"):
        query = getattr(lib, f"segment_sum_csr_{key}")
        query.argtypes, query.restype = [], ctypes.c_int
        out[key] = query()
    return out


def launch_info(x, rowptr, perm=None):
    """The launch a call on ``x`` makes: {'blocks', 'threads', 'cluster',
    'slot_blocks', 'smem_bytes', 'max_active_clusters'} (the last from
    ``cudaOccupancyMaxActiveClusters``: 0 if the card cannot run it)."""
    lib = build.load("segment_sum_csr")
    fn = lib.segment_sum_csr_launch_info
    i32 = ctypes.c_int
    fn.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    fn.restype = i32
    got = (i32 * 6)()
    slots = perm.shape[0] if perm is not None else x.shape[0]
    C = math.prod(x.shape[1:])
    vec = int(x.dtype == torch.float32 and C % 4 == 0)
    with torch.cuda.device(x.device):
        err = fn(rowptr.shape[0] - 1, slots, C, _DTYPES[x.dtype], vec, got)
    if err != 0:
        raise RuntimeError(f"segment_sum_csr launch_info: cudaError {err}")
    return dict(zip(("blocks", "threads", "cluster", "slot_blocks",
                     "smem_bytes", "max_active_clusters"), list(got)))


def ticket_merges(device) -> int:
    """The segments that the kernel's launches on CUDA ``device`` merged
    at the global level (a segment longer than one cluster's span, its
    pieces' sums added by a ticket's last holder) since the last call, as
    the kernels counted them on the device; the count starts again at 0.
    Synchronizes with the device: not during a graph capture."""
    lib = build.load("segment_sum_csr")
    fn = lib.segment_sum_csr_ticket_merges
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    got = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        err = fn(ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"segment_sum_csr ticket_merges: cudaError {err}")
    return got.value


def _launch(x, rowptr, perm=None, limit=None):
    launch = _bind()
    dev = x.device
    if x.dtype not in _DTYPES:
        raise TypeError(f"segment_sum_csr kernel: x has dtype {x.dtype}, "
                        "expected float32, bfloat16 or float16")
    if not x.is_contiguous():
        raise ValueError("segment_sum_csr kernel: x must be contiguous")
    S = rowptr.shape[0] - 1
    common.check("rowptr", rowptr, dev, torch.int32, (S + 1,))
    slots = x.shape[0]
    if perm is not None:
        slots = perm.shape[0]
        common.check("perm", perm, dev, torch.int32, (slots,))
    if limit is not None:
        common.check("limit", limit, dev, torch.int32, (1,))
    C = math.prod(x.shape[1:])
    out = torch.empty((S,) + tuple(x.shape[1:]), device=dev, dtype=x.dtype)
    if S == 0 or C == 0:
        return out
    # a piece's sum of a segment longer than one cluster's span, at most
    # one a probe, and a ticket a probe
    probes = slots // constants()["probe"] + 1
    part = torch.empty((probes * C,), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = common.tickets(dev, stream, probes)
    vec = int(x.dtype == torch.float32 and C % 4 == 0
              and common.aligned(x, out))
    common.run(launch, "segment_sum_csr", dev, (
        x.data_ptr(), rowptr.data_ptr(),
        perm.data_ptr() if perm is not None else None,
        limit.data_ptr() if limit is not None else None, out.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), S, slots, C, _DTYPES[x.dtype],
        vec), stream)
    segment_sum_csr.launches += 1
    return out


def segment_sum_csr(x, rowptr, perm=None, limit=None):
    """The sum of ``x``'s rows [n, ...] over each CSR segment, not
    differentiable: [S, ...] in ``x``'s dtype.  ``rowptr`` [S+1] and
    ``perm`` [slots] (or None: slot k is row k) are int32; the slots past
    ``rowptr[-1]`` are not read, nor those at or past ``limit`` (None, or
    a one-element int32 tensor on ``x``'s device, e.g. a view
    ``csr_rowptr[N:]``: read on the device, so a CUDA graph may capture
    the call).  CPU tensors run :func:`segment_sum_csr_plain`, CUDA
    tensors the kernel (float32, bfloat16 or float16 ``x``, contiguous)
    or raise."""
    if x.device.type == "cpu":
        return segment_sum_csr_plain(x, rowptr, perm, limit=limit)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum_csr runs on cpu or cuda, not "
                         f"{x.device}")
    return _launch(x, rowptr, perm, limit)


segment_sum_csr.launches = 0


class _CsrSegmentSum(torch.autograd.Function):
    """Forward: the kernel; backward: each entry takes its segment's
    cotangent (a gather by ``ids``, the segment of every row of x)."""

    @staticmethod
    def forward(ctx, x, ids, rowptr, perm):
        ctx.save_for_backward(ids)
        return segment_sum_csr(x.contiguous(), rowptr, perm)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return g.index_select(0, ids), None, None, None


def csr_segment_sum(x, ids, rowptr, perm=None):
    """Differentiable :func:`segment_sum_csr` of ``x`` [n, ...], whose row
    i lies in segment ``ids[i]`` (int64 [n]; every row in one segment, as
    the CSR lists it)."""
    return _CsrSegmentSum.apply(x, ids, rowptr, perm)


class _GatherRows(torch.autograd.Function):
    """Forward: ``index_select``; backward: the kernel sums each row's
    cotangents over the CSR of ``ids``."""

    @staticmethod
    def forward(ctx, x, ids, rowptr, perm):
        ctx.save_for_backward(rowptr, perm)
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        rowptr, perm = ctx.saved_tensors
        return (segment_sum_csr(g.contiguous(), rowptr, perm), None, None,
                None)


def gather_rows(x, ids, rowptr, perm=None):
    """``x.index_select(0, ids)`` whose backward sums in a fixed order:
    ``rowptr`` [len(x)+1] and ``perm`` group the positions of ``ids``
    (int64) by their value, the CSR of ``ids`` (int32; every position
    listed once)."""
    return _GatherRows.apply(x, ids, rowptr, perm)
