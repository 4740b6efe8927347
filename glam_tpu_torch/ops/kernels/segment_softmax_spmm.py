"""Segment softmax + SpMM: the CUDA kernels, their plain torch versions
and the ``autograd.Function`` around them.

For every row r of a CSR over M entries, with logits [M, H] and
head-major values [M, H*C]::

    alpha_e = segment_softmax(logits over the entries of r)   (per head)
    out[r]  = sum_e alpha_e * values[e]                          [R, H*C]

with PyG's semantics (max shift, +1e-16 in the denominator, 0 for empty
rows).  The CSR is ``rowptr`` [R+1] and ``idx`` [S], the entry of each
slot (int32; an entry listed at most once).  The attention-style
aggregations of ``TripletMessageLight`` and ``GATConv`` (rows are
receivers, entries edges) and the ``GlobalLAPool`` and ``Set2Set``
readouts (rows are graphs, entries nodes) run through it.

The forward also gives each row's statistics, ``row_max`` [R, H] and
``row_inv`` = 1 / (sum of exp + 1e-16) [R, H] (both 0 for an empty row);
the backward takes them and the output, whose dot with the cotangent is
the softmax backward's row sum, so no entry waits for the rest of its
row.

The forward kernel (``glam_tpu_torch/csrc/segment_softmax_spmm.cu``)
replaces the Pallas TPU kernel ``_kernel`` of the JAX package
(``glam_tpu/ops/pallas/segment_mxu.py:100``, ``fused_segment_softmax_spmm``
:160).  The TPU kernel has no backward; the JAX package differentiates
``segment_softmax`` and ``segment_sum`` with XLA, and the backward
kernel (``csrc/segment_softmax_spmm_bwd.cu``) computes that gradient.
Each call is one CUDA kernel over blocks of 1-8 warps, 32 CSR slots a
warp (:func:`block_warps`).  In the forward, rows that cross blocks are
merged by the block that takes their last ticket; the tickets live in a
zeroed buffer kept per device and stream, which each kernel leaves
zeroed.

``segment_softmax_spmm`` is the differentiable op.  CPU tensors run the
plain versions; CUDA tensors run the kernels or raise.
``segment_softmax_spmm.launches`` counts forward launches and
``segment_softmax_spmm_bwd.launches`` backward ones.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import csr_rows, index_sum
from . import build, common

_EPS = 1e-16


def _rows_alpha(logits, rowptr, idx, row_max, row_inv):
    """(row of each slot, entry of each slot, the slots' softmax weights
    [S, H]) from the row statistics."""
    rows = csr_rows(rowptr, idx.shape[0])
    e = idx.long()
    alpha = (torch.exp(logits.index_select(0, e) - row_max.index_select(
        0, rows)) * row_inv.index_select(0, rows))
    return rows, e, alpha


def segment_softmax_spmm_plain(logits, values, rowptr, idx):
    """The forward kernel's function in plain torch: logits [M, H],
    values [M, H*C], rowptr [R+1], idx [S] -> (out [R, H*C], row_max
    [R, H], row_inv [R, H])."""
    R, H = rowptr.shape[0] - 1, logits.shape[1]
    C = values.shape[1] // H
    rows = csr_rows(rowptr, idx.shape[0])
    x = logits.index_select(0, idx.long())
    row_max = x.new_full((R, H), -torch.inf).index_reduce_(
        0, rows, x, "amax", include_self=True)
    nonempty = (rowptr[1:] > rowptr[:-1])[:, None]
    row_max = torch.where(nonempty, row_max, torch.zeros_like(row_max))
    ex = torch.exp(x - row_max.index_select(0, rows))
    row_inv = torch.where(nonempty, 1.0 / (index_sum(ex, rows, R) + _EPS),
                          torch.zeros_like(row_max))
    alpha = ex * row_inv.index_select(0, rows)
    vals = values.index_select(0, idx.long())
    out = index_sum(alpha.repeat_interleave(C, dim=1) * vals, rows, R)
    return out, row_max, row_inv


def segment_softmax_spmm_bwd_plain(logits, values, rowptr, idx, out,
                                   row_max, row_inv, g):
    """The backward kernel's function in plain torch, written out as the
    kernel computes it (not by autograd).  ``out``, ``row_max`` and
    ``row_inv`` are the forward's results, g [R, H*C] the output's
    cotangent.  Returns (d_logits [M, H], d_values [M, H*C]), zero for
    entries that no slot lists."""
    R, H = rowptr.shape[0] - 1, logits.shape[1]
    C = values.shape[1] // H
    rows, e, alpha = _rows_alpha(logits, rowptr, idx, row_max, row_inv)
    grow = g.index_select(0, rows)                            # [S, H*C]
    dalpha = (grow * values.index_select(0, e)).view(-1, H, C).sum(-1)
    # softmax backward: alpha * (dalpha - sum_row alpha * dalpha), the row
    # sum being <g[r], out[r]> per head
    row_d = (g * out).view(R, H, C).sum(-1).index_select(0, rows)
    d_logits = torch.zeros_like(logits).index_copy_(
        0, e, alpha * (dalpha - row_d))
    d_values = torch.zeros_like(values).index_copy_(
        0, e, alpha.repeat_interleave(C, dim=1) * grow)
    return d_logits, d_values


def block_warps(slots: int, sms: int, rows: int | None = None) -> int:
    """Warps per block (32 CSR slots each) for ``slots`` slots on a card
    of ``sms`` SMs: the fewest of 1-8 that leave at most one block per SM,
    so that the blocks spread over the SMs.  The forward passes its
    ``rows``: where they average more than 32 slots, rows cross blocks
    often and each crossing is a merge through global memory, so it takes
    8 warps, the fewest block states."""
    if rows is not None and slots > 32 * rows:
        return 8
    chunks = -(-slots // 32)
    return min(8, max(1, -(-chunks // sms)))


@functools.cache
def _bind(name: str, prefix: str, n_ptrs: int, n_ints: int):
    """Load kernel source ``name`` and type its launch ``prefix``
    (``n_ptrs`` pointers, ``n_ints`` ints, stream).  Returns (the launch,
    its largest H*C, its most heads)."""
    lib = build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, prefix)
    launch.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [ptr]
    launch.restype = i32
    limits = []
    for fn in ("max_hc", "max_heads"):
        query = getattr(lib, f"{prefix}_{fn}")
        query.argtypes, query.restype = [], i32
        limits.append(query())
    return (launch, *limits)


def _check_inputs(limits, logits, values, rowptr, idx, extra=()):
    """Raise on what the kernels do not take: devices, dtypes, shapes,
    contiguity and the widths' limits.  ``extra`` holds (name, tensor,
    shape) of further float32 inputs.  Returns (R, S, H*C, H, C)."""
    M, H = logits.shape[0], logits.shape[1] if logits.dim() == 2 else -1
    hc = values.shape[1] if values.dim() == 2 else -1
    R, S = rowptr.shape[0] - 1, idx.shape[0]
    dev, f32, i32 = logits.device, torch.float32, torch.int32
    checks = [("logits", logits, f32, (M, H)),
              ("values", values, f32, (M, hc)),
              ("rowptr", rowptr, i32, (R + 1,)), ("idx", idx, i32, (S,))]
    checks += [(name, t, f32, shape) for name, t, shape in extra]
    for name, t, dtype, shape in checks:
        common.check(name, t, dev, dtype, shape)
    max_hc, max_heads = limits
    if hc > max_hc or H > max_heads:
        raise ValueError(f"segment_softmax_spmm kernel: H*C = {hc}, heads = "
                         f"{H} exceeds its maximum of {max_hc}, {max_heads}")
    if H < 1 or hc % H:
        raise ValueError(f"segment_softmax_spmm kernel: values width {hc} "
                         f"is not a multiple of the {H} heads")
    return R, S, hc, H, hc // H


def _copy_mode(hc: int, *rows) -> int:
    """The kernels' CopyMode for gathering rows of ``hc`` floats of
    ``rows``: 1 (cp.async.bulk) where the rows are a multiple of 16 bytes
    at 16-byte-aligned addresses, else 0 (4-byte cp.async)."""
    return int(hc % 4 == 0 and common.aligned(*rows))


def _launch_fwd(logits, values, rowptr, idx):
    launch, max_hc, max_heads = _bind(
        "segment_softmax_spmm", "segment_spmm_fwd", 9, 7)
    R, S, hc, H, C = _check_inputs((max_hc, max_heads), logits, values,
                                   rowptr, idx)
    dev = logits.device
    warps = block_warps(S, common.sms(dev.index), R)
    blocks = max(1, -(-S // (32 * warps)))
    # one allocation: out [R, H*C], row_max, row_inv [R, H] and the
    # per-block states of rows crossing blocks [blocks, 2, sw], each part
    # 16-byte aligned
    sizes = [common.up4(R * hc), common.up4(R * H), common.up4(R * H),
             blocks * 2 * common.up4(hc + 2 * H)]
    buf = torch.empty((sum(sizes),), device=dev, dtype=torch.float32)
    out, row_max, row_inv, part = buf.split(sizes)
    out, row_max, row_inv = (out[:R * hc].view(R, hc),
                             row_max[:R * H].view(R, H),
                             row_inv[:R * H].view(R, H))
    if R == 0:
        return out, row_max, row_inv
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = common.tickets(dev, stream, blocks)
    common.run(launch, "segment_spmm_fwd", dev, (
        logits.data_ptr(), values.data_ptr(), rowptr.data_ptr(),
        idx.data_ptr(), out.data_ptr(), row_max.data_ptr(),
        row_inv.data_ptr(), part.data_ptr(), tickets.data_ptr(), R, S, hc,
        H, C, _copy_mode(hc, values), warps), stream)
    segment_softmax_spmm.launches += 1
    return out, row_max, row_inv


def _launch_bwd(logits, values, rowptr, idx, out, row_max, row_inv, g):
    launch, max_hc, max_heads = _bind(
        "segment_softmax_spmm_bwd", "segment_spmm_bwd", 10, 7)
    R, H, hc = rowptr.shape[0] - 1, logits.shape[-1], values.shape[-1]
    R, S, hc, H, C = _check_inputs(
        (max_hc, max_heads), logits, values, rowptr, idx,
        [("out", out, (R, hc)), ("row_max", row_max, (R, H)),
         ("row_inv", row_inv, (R, H)), ("g", g, (R, hc))])
    dev, M = logits.device, logits.shape[0]
    # entries that no slot lists keep zeros; with S == M every entry is
    # listed once and the kernel writes all of them.  d_values first, so
    # that it is 16-byte aligned
    alloc = torch.empty if S == M else torch.zeros
    at = common.up4(M * hc)
    grads = alloc((at + M * H,), device=dev, dtype=torch.float32)
    d_values = grads[:M * hc].view(M, hc)
    d_logits = grads[at:].view(M, H)
    if R == 0 or S == 0:
        return d_logits, d_values
    stream = torch.cuda.current_stream(dev).cuda_stream
    common.run(launch, "segment_spmm_bwd", dev, (
        logits.data_ptr(), values.data_ptr(), rowptr.data_ptr(),
        idx.data_ptr(), out.data_ptr(), g.data_ptr(), row_max.data_ptr(),
        row_inv.data_ptr(), d_logits.data_ptr(), d_values.data_ptr(), R, S,
        hc, H, C, _copy_mode(hc, values, g, out),
        block_warps(S, common.sms(dev.index))), stream)
    segment_softmax_spmm_bwd.launches += 1
    return d_logits, d_values


def _route(t, plain, kernel):
    if t.device.type == "cpu":
        return plain
    if t.device.type != "cuda":
        raise ValueError(f"segment_softmax_spmm runs on cpu or cuda, not "
                         f"{t.device}")
    return kernel


def segment_softmax_spmm_fwd(logits, values, rowptr, idx):
    """The forward alone, not differentiable: (out, row_max, row_inv).
    CPU tensors run :func:`segment_softmax_spmm_plain`, CUDA tensors the
    forward kernel (float32 logits and values, int32 CSR, all contiguous,
    H up to 8 and H*C up to 512) or raise."""
    fn = _route(logits, segment_softmax_spmm_plain, _launch_fwd)
    return fn(logits, values, rowptr, idx)


def segment_softmax_spmm_bwd(logits, values, rowptr, idx, out, row_max,
                             row_inv, g):
    """The backward: CPU tensors run :func:`segment_softmax_spmm_bwd_plain`,
    CUDA tensors the backward kernel (as the forward takes them; the
    forward's out, row_max and row_inv and g [R, H*C], float32
    contiguous) or raise."""
    fn = _route(logits, segment_softmax_spmm_bwd_plain, _launch_bwd)
    return fn(logits, values, rowptr, idx, out, row_max, row_inv, g)


class _SegmentSoftmaxSpmm(torch.autograd.Function):
    """Forward and backward through the kernels (or their plain versions
    on the CPU); the inputs, the output and the rows' statistics are kept
    between the two."""

    @staticmethod
    def forward(ctx, logits, values, rowptr, idx):
        out, row_max, row_inv = segment_softmax_spmm_fwd(logits, values,
                                                         rowptr, idx)
        ctx.save_for_backward(logits, values, rowptr, idx, out, row_max,
                              row_inv)
        return out

    @staticmethod
    def backward(ctx, g):
        d_logits, d_values = segment_softmax_spmm_bwd(
            *ctx.saved_tensors, g.contiguous())
        return d_logits, d_values, None, None


def segment_softmax_spmm(logits, values, rowptr, idx):
    """Segment softmax + weighted sum per CSR row, differentiable in
    logits and values.  Arguments as for
    :func:`segment_softmax_spmm_plain`, returns out [R, H*C]; CPU tensors
    run the plain versions, CUDA tensors the kernels or raise."""
    return _SegmentSoftmaxSpmm.apply(logits, values, rowptr, idx)


segment_softmax_spmm.launches = 0
segment_softmax_spmm_bwd.launches = 0
