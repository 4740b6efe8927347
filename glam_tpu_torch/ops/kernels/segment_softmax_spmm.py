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

The forward kernel (``glam_tpu_torch/csrc/segment_softmax_spmm.cu``)
replaces the Pallas TPU kernel ``_kernel`` of the JAX package
(``glam_tpu/ops/pallas/segment_mxu.py:100``, ``fused_segment_softmax_spmm``
:160).  The TPU kernel has no backward; the JAX package differentiates
``segment_softmax`` and ``segment_sum`` with XLA, and the backward
kernel (``csrc/segment_softmax_spmm_bwd.cu``) computes that gradient.
Both cut the CSR into chunks of 32 slots, one warp each, so a long row
is spread over many warps and merged after.

``segment_softmax_spmm`` is the differentiable op.  CPU tensors run the
plain versions; CUDA tensors run the kernels or raise.
``segment_softmax_spmm.launches`` counts forward launches and
``segment_softmax_spmm_bwd.launches`` backward ones (one per call, each
of which runs two or three CUDA kernels).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import csr_rows, segment_softmax, segment_sum
from . import build
from .triplet_fused import _check


def _gathered(logits, values, rowptr, idx):
    """(row of each slot, entry of each slot, the slots' softmax weights
    [S, H], the slots' values [S, H*C])."""
    rows = csr_rows(rowptr, idx.shape[0])
    e = idx.long()
    alpha = segment_softmax(logits.index_select(0, e), rows,
                            rowptr.shape[0] - 1)
    return rows, e, alpha, values.index_select(0, e)


def segment_softmax_spmm_plain(logits, values, rowptr, idx):
    """The forward kernel's function in plain torch: logits [M, H],
    values [M, H*C], rowptr [R+1], idx [S] -> [R, H*C]."""
    rows, _, alpha, vals = _gathered(logits, values, rowptr, idx)
    C = values.shape[1] // logits.shape[1]
    return segment_sum(alpha.repeat_interleave(C, dim=1) * vals, rows,
                       rowptr.shape[0] - 1)


def segment_softmax_spmm_bwd_plain(logits, values, rowptr, idx, g):
    """The backward kernel's function in plain torch, written out as the
    kernel computes it (not by autograd).  g [R, H*C] is the output's
    cotangent.  Returns (d_logits [M, H], d_values [M, H*C]), zero for
    entries that no slot lists."""
    R, H = rowptr.shape[0] - 1, logits.shape[1]
    C = values.shape[1] // H
    rows, e, alpha, vals = _gathered(logits, values, rowptr, idx)
    grow = g.index_select(0, rows)                            # [S, H*C]
    dalpha = (grow * vals).view(-1, H, C).sum(-1)             # [S, H]
    # softmax backward: alpha * (dalpha - sum_row alpha * dalpha)
    row_d = segment_sum(alpha * dalpha, rows, R).index_select(0, rows)
    d_logits = torch.zeros_like(logits).index_copy_(
        0, e, alpha * (dalpha - row_d))
    d_values = torch.zeros_like(values).index_copy_(
        0, e, alpha.repeat_interleave(C, dim=1) * grow)
    return d_logits, d_values


@functools.cache
def _bind(name: str, prefix: str, n_ptrs: int) -> ctypes.CDLL:
    """Load kernel source ``name`` and type its entry points: the launch
    ``prefix`` (``n_ptrs`` pointers, rows, slots, H*C, H, C, merge blocks,
    stream) and the ``{prefix}_*`` queries of its limits."""
    lib = build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, prefix)
    launch.argtypes = [ptr] * n_ptrs + [i32] * 6 + [ptr]
    launch.restype = i32
    for fn in ("max_hc", "max_heads", "chunk"):
        getattr(lib, f"{prefix}_{fn}").argtypes = []
        getattr(lib, f"{prefix}_{fn}").restype = i32
    return lib


def _check_inputs(lib, prefix, logits, values, rowptr, idx, g=None):
    """Raise on what the kernels do not take: devices, dtypes, shapes,
    contiguity and the widths' limits.  Returns (R, S, H*C, H, C)."""
    M, H = logits.shape[0], logits.shape[1] if logits.dim() == 2 else -1
    hc = values.shape[1] if values.dim() == 2 else -1
    R, S = rowptr.shape[0] - 1, idx.shape[0]
    dev, f32, i32 = logits.device, torch.float32, torch.int32
    checks = [("logits", logits, f32, (M, H)), ("values", values, f32,
                                                 (M, hc)),
              ("rowptr", rowptr, i32, (R + 1,)), ("idx", idx, i32, (S,))]
    if g is not None:
        checks.append(("g", g, f32, (R, hc)))
    for name, t, dtype, shape in checks:
        _check(name, t, dev, dtype, shape)
    max_hc = getattr(lib, f"{prefix}_max_hc")()
    max_heads = getattr(lib, f"{prefix}_max_heads")()
    if hc > max_hc or H > max_heads:
        raise ValueError(f"segment_softmax_spmm kernel: H*C = {hc}, heads = "
                         f"{H} exceeds its maximum of {max_hc}, {max_heads}")
    if H < 1 or hc % H:
        raise ValueError(f"segment_softmax_spmm kernel: values width {hc} "
                         f"is not a multiple of the {H} heads")
    return R, S, hc, H, hc // H


def _merge_blocks(dev, items: int, per_block: int) -> int:
    """The merge pass's grid: a block per ``per_block`` work items (rows
    or listed rows), at most 4 blocks per SM; blocks stride over the
    rest."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-items // per_block), 4 * sms))


def _launch_fwd(logits, values, rowptr, idx):
    lib = _bind("segment_softmax_spmm", "segment_spmm_fwd", 10)
    R, S, hc, H, C = _check_inputs(lib, "segment_spmm_fwd", logits, values,
                                   rowptr, idx)
    dev, f32 = logits.device, torch.float32
    if R == 0 or S == 0:
        return torch.zeros((R, hc), device=dev, dtype=f32)
    # one zero-fill for the output (empty rows keep it) and the two
    # counters of the work lists, kept as int32 bits behind it
    zeroed = torch.zeros((R * hc + 2,), device=dev, dtype=f32)
    out, counts = zeroed[:R * hc].view(R, hc), zeroed[R * hc:]
    chunks = -(-S // lib.segment_spmm_fwd_chunk())
    # scratch: the partial states [chunks, 2, H | H | H*C] and the two
    # lists of rows that span chunks [2, chunks]
    part_m, part_l, part_acc, lists = torch.empty(
        (chunks * 2 * (2 * H + hc + 1),), device=dev, dtype=f32).split(
            [2 * chunks * H, 2 * chunks * H, 2 * chunks * hc, 2 * chunks])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_spmm_fwd(
            logits.data_ptr(), values.data_ptr(), rowptr.data_ptr(),
            idx.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), counts.data_ptr(),
            lists.data_ptr(), R, S, hc, H, C,
            _merge_blocks(dev, chunks, 16), stream)
    if err != 0:
        raise RuntimeError(f"segment_spmm_fwd launch failed with cudaError "
                           f"{err}")
    segment_softmax_spmm.launches += 1
    return out


def _launch_bwd(logits, values, rowptr, idx, g):
    lib = _bind("segment_softmax_spmm_bwd", "segment_spmm_bwd", 15)
    R, S, hc, H, C = _check_inputs(lib, "segment_spmm_bwd", logits, values,
                                   rowptr, idx, g)
    dev, f32, M = logits.device, torch.float32, logits.shape[0]
    # entries that no slot lists keep zeros; with S == M every entry is
    # listed once and the kernel writes all of them
    alloc = torch.empty if S == M else torch.zeros
    d_logits = alloc((M, H), device=dev, dtype=f32)
    d_values = alloc((M, hc), device=dev, dtype=f32)
    if R == 0 or S == 0:
        return d_logits, d_values
    chunks = -(-S // lib.segment_spmm_bwd_chunk())
    scratch = torch.empty((S * H + 3 * R * H + 6 * chunks * H,), device=dev,
                          dtype=f32)
    sizes = [S * H] + [R * H] * 3 + [2 * chunks * H] * 3
    dal, row_m, row_inv, row_d, part_m, part_l, part_s = scratch.split(sizes)
    slot_row = torch.empty((S,), device=dev, dtype=torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_spmm_bwd(
            logits.data_ptr(), values.data_ptr(), rowptr.data_ptr(),
            idx.data_ptr(), g.data_ptr(), d_logits.data_ptr(),
            d_values.data_ptr(), dal.data_ptr(), slot_row.data_ptr(),
            row_m.data_ptr(), row_inv.data_ptr(), row_d.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_s.data_ptr(), R, S,
            hc, H, C, _merge_blocks(dev, R, 8), stream)
    if err != 0:
        raise RuntimeError(f"segment_spmm_bwd launch failed with cudaError "
                           f"{err}")
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
    """The forward alone, not differentiable: CPU tensors run
    :func:`segment_softmax_spmm_plain`, CUDA tensors the forward kernel
    (float32 logits and values, int32 CSR, all contiguous, H up to 8 and
    H*C up to 512) or raise."""
    fn = _route(logits, segment_softmax_spmm_plain, _launch_fwd)
    return fn(logits, values, rowptr, idx)


def segment_softmax_spmm_bwd(logits, values, rowptr, idx, g):
    """The backward: CPU tensors run :func:`segment_softmax_spmm_bwd_plain`,
    CUDA tensors the backward kernel (as the forward takes them, g
    [R, H*C] float32 contiguous) or raise."""
    fn = _route(logits, segment_softmax_spmm_bwd_plain, _launch_bwd)
    return fn(logits, values, rowptr, idx, g)


class _SegmentSoftmaxSpmm(torch.autograd.Function):
    """Forward and backward through the kernels (or their plain versions
    on the CPU); nothing but the inputs is kept between the two."""

    @staticmethod
    def forward(ctx, logits, values, rowptr, idx):
        ctx.save_for_backward(logits, values, rowptr, idx)
        return segment_softmax_spmm_fwd(logits, values, rowptr, idx)

    @staticmethod
    def backward(ctx, g):
        logits, values, rowptr, idx = ctx.saved_tensors
        d_logits, d_values = segment_softmax_spmm_bwd(
            logits, values, rowptr, idx, g.contiguous())
        return d_logits, d_values, None, None


def segment_softmax_spmm(logits, values, rowptr, idx):
    """Segment softmax + weighted sum per CSR row, differentiable in
    logits and values.  Arguments as for
    :func:`segment_softmax_spmm_plain`; CPU tensors run the plain
    versions, CUDA tensors the kernels or raise."""
    return _SegmentSoftmaxSpmm.apply(logits, values, rowptr, idx)


segment_softmax_spmm.launches = 0
segment_softmax_spmm_bwd.launches = 0
