"""Fused TripletMessage attention: the CUDA kernels, their plain torch
versions and the ``autograd.Function`` around them.

Kernel A (``glam_tpu_torch/csrc/triplet_fused.cu``) is the forward; it
replaces the Pallas TPU kernel ``_fwd_kernel`` of the JAX package
(``glam_tpu/ops/pallas/triplet_fused.py:236``).  Kernel B
(``glam_tpu_torch/csrc/triplet_fused_bwd.cu``) is the backward; it
replaces ``_bwd_kernel`` (same file, :296).  Both walk a receiver-sorted
CSR of the real edges, one warp per receiver row, and are bounded by
memory traffic.  The backward recomputes the forward, as the TPU kernel
does: nothing but the inputs is kept between the two.

``triplet_attention`` is the differentiable op (the Function's
``apply``).  CPU tensors run the plain versions; CUDA tensors run the
kernels or raise.  ``triplet_attention.launches`` counts launches of
kernel A and ``triplet_attention_bwd.launches`` those of kernel B.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import csr_rows, segment_softmax, segment_sum
from . import build

_SMEM_LIMIT = 48 * 1024   # shared memory without an opt-in attribute


def _attention(xp, a_i, a_j, edge_attr, we, wemat, rcv, snd, eid, num_heads,
               slope):
    """The recomputed forward of the CSR edges: (eh, pre_raw, alpha)."""
    eh = edge_attr[eid] @ we                                  # [E, H*C]
    pre_raw = a_i[rcv] + eh @ wemat + a_j[snd]                # [E, H]
    pre = torch.where(pre_raw >= 0, pre_raw, slope * pre_raw)
    return eh, pre_raw, segment_softmax(pre, rcv, xp.shape[0])


def triplet_attention_plain(xp, a_i, a_j, edge_attr, we, wemat,
                            csr_rowptr, csr_snd, csr_eid, num_heads: int,
                            channels: int, slope: float = 0.2):
    """The forward kernel's function in plain torch (PyG segment-softmax
    semantics: max shift, +1e-16 in the denominator, 0 for empty rows).

    xp [N, H*C] head-major, a_i/a_j [N, H], edge_attr [E, Fe] raw edge
    features in original edge order, we [Fe, H*C], wemat [H*C, H]
    (a_e = (edge_attr @ we) @ wemat), and the receiver-sorted CSR of the
    real edges: csr_rowptr [N+1], csr_snd [E_real], csr_eid [E_real]
    (int32).  Returns [N, H*C]."""
    rcv = csr_rows(csr_rowptr, csr_snd.shape[0])
    snd = csr_snd.long()
    eh, _, alpha = _attention(xp, a_i, a_j, edge_attr, we, wemat, rcv, snd,
                              csr_eid.long(), num_heads, slope)
    alpha_full = alpha.repeat_interleave(channels, dim=1)
    return segment_sum(alpha_full * eh * xp[snd], rcv, xp.shape[0])


def triplet_attention_bwd_plain(xp, a_i, a_j, edge_attr, we, wemat,
                                csr_rowptr, csr_snd, csr_eid, g,
                                num_heads: int, channels: int,
                                slope: float = 0.2):
    """The backward kernel's function in plain torch, written out as
    ``_bwd_kernel`` computes it (not by autograd).

    Arguments as for :func:`triplet_attention_plain`, plus the output's
    cotangent g [N, H*C].  Returns (d_xp [N, H*C], d_eh [E, H*C],
    d_pre [E, H], d_a_i [N, H]): d_eh and d_pre are the cotangents of the
    edge projection eh = edge_attr @ we and of the attention logit before
    the leaky ReLU, in original edge order, zero for edges outside the
    CSR (padding)."""
    H, C = num_heads, channels
    N, E = xp.shape[0], edge_attr.shape[0]
    rcv = csr_rows(csr_rowptr, csr_snd.shape[0])
    snd, eid = csr_snd.long(), csr_eid.long()
    eh, pre_raw, alpha = _attention(xp, a_i, a_j, edge_attr, we, wemat, rcv,
                                    snd, eid, H, slope)
    xj, grcv = xp[snd], g[rcv]
    dvalues = alpha.repeat_interleave(C, dim=1) * grcv        # [E, H*C]
    dalpha = (eh * xj * grcv).view(-1, H, C).sum(-1)          # [E, H]
    # softmax backward: dpre = alpha * (dalpha - sum_row alpha * dalpha)
    row = segment_sum(alpha * dalpha, rcv, N)[rcv]
    dpre = alpha * (dalpha - row)
    dpre = dpre * torch.where(pre_raw >= 0, 1.0, slope).to(dpre.dtype)
    d_xp = segment_sum(dvalues * eh, snd, N)                  # to senders
    d_eh = xp.new_zeros((E, H * C))
    d_eh[eid] = dvalues * xj + dpre @ wemat.T
    d_pre = xp.new_zeros((E, H))
    d_pre[eid] = dpre
    return d_xp, d_eh, d_pre, segment_sum(dpre, rcv, N)


@functools.cache
def _bind(name: str, prefix: str, launch: str, n_ptrs: int) -> ctypes.CDLL:
    """Load kernel source ``name`` and type its C entry points: the launch
    ``launch`` (``n_ptrs`` pointers, N, H*C, H, C, Fe, slope, blocks,
    stream) and the ``{prefix}_*`` queries of its limits."""
    lib = build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    getattr(lib, launch).argtypes = ([ptr] * n_ptrs + [i32] * 5
                                     + [ctypes.c_float, i32, ptr])
    getattr(lib, launch).restype = i32
    for fn in ("max_hc", "max_heads", "warps_per_block"):
        getattr(lib, f"{prefix}_{fn}").argtypes = []
        getattr(lib, f"{prefix}_{fn}").restype = i32
    getattr(lib, f"{prefix}_blocks_per_sm").argtypes = [i32] * 4
    getattr(lib, f"{prefix}_blocks_per_sm").restype = i32
    getattr(lib, f"{prefix}_smem_bytes").argtypes = [i32] * 3
    getattr(lib, f"{prefix}_smem_bytes").restype = ctypes.c_longlong
    return lib


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(lib, prefix, xp, a_i, a_j, edge_attr, we, wemat,
                  csr_rowptr, csr_snd, csr_eid, H, C, g=None):
    """Raise on what the kernels do not take: devices, dtypes, shapes,
    contiguity and the widths' limits."""
    N, hc = xp.shape[0], H * C
    E, fe = edge_attr.shape[0], edge_attr.shape[1]
    dev, f32, i32 = xp.device, torch.float32, torch.int32
    checks = [("xp", xp, f32, (N, hc)), ("a_i", a_i, f32, (N, H)),
              ("a_j", a_j, f32, (N, H)), ("edge_attr", edge_attr, f32, (E, fe)),
              ("we", we, f32, (fe, hc)), ("wemat", wemat, f32, (hc, H)),
              ("csr_rowptr", csr_rowptr, i32, (N + 1,)),
              ("csr_snd", csr_snd, i32, (csr_snd.shape[0],)),
              ("csr_eid", csr_eid, i32, (csr_snd.shape[0],))]
    if g is not None:
        checks.append(("g", g, f32, (N, hc)))
    for name, t, dtype, shape in checks:
        _check(name, t, dev, dtype, shape)
    smem = getattr(lib, f"{prefix}_smem_bytes")(hc, H, fe)
    limits = {"H*C": (hc, getattr(lib, f"{prefix}_max_hc")()),
              "heads": (H, getattr(lib, f"{prefix}_max_heads")()),
              "shared memory bytes": (smem, _SMEM_LIMIT)}
    for what, (got, most) in limits.items():
        if got > most:
            raise ValueError(f"triplet_attention kernel: {what} = {got} "
                             f"exceeds its maximum of {most}")


@functools.cache
def _resident_blocks(lib, prefix, dev, hc, heads, channels, fe) -> int:
    """Blocks of a kernel that fit on the card at once: the grid, so that
    every block is resident and each warp walks many rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = getattr(lib, f"{prefix}_blocks_per_sm")(hc, heads, channels, fe)
    return sms * max(per_sm, 1)


def _grid(lib, prefix, xp, edge_attr, H, C) -> int:
    rows_per_block = getattr(lib, f"{prefix}_warps_per_block")()
    return min(-(-xp.shape[0] // rows_per_block),
               _resident_blocks(lib, prefix, xp.device, H * C, H, C,
                                edge_attr.shape[1]))


def _launch_fwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                csr_eid, num_heads, channels, slope):
    H, C = int(num_heads), int(channels)
    lib = _bind("triplet_fused", "triplet_fused", "triplet_fused_fwd", 10)
    _check_inputs(lib, "triplet_fused", xp, a_i, a_j, edge_attr, we, wemat,
                  csr_rowptr, csr_snd, csr_eid, H, C)
    N, hc, fe = xp.shape[0], H * C, edge_attr.shape[1]
    out = torch.empty((N, hc), device=xp.device, dtype=torch.float32)
    if N == 0:
        return out
    blocks = _grid(lib, "triplet_fused", xp, edge_attr, H, C)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.triplet_fused_fwd(
            xp.data_ptr(), a_i.data_ptr(), a_j.data_ptr(),
            edge_attr.data_ptr(), we.data_ptr(), wemat.data_ptr(),
            csr_rowptr.data_ptr(), csr_snd.data_ptr(), csr_eid.data_ptr(),
            out.data_ptr(), N, hc, H, C, fe, float(slope), blocks, stream)
    if err != 0:
        raise RuntimeError(f"triplet_fused_fwd launch failed with "
                           f"cudaError {err}")
    triplet_attention.launches += 1
    return out


def _launch_bwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                csr_eid, g, num_heads, channels, slope):
    H, C = int(num_heads), int(channels)
    lib = _bind("triplet_fused_bwd", "triplet_bwd", "triplet_bwd", 14)
    _check_inputs(lib, "triplet_bwd", xp, a_i, a_j, edge_attr, we, wemat,
                  csr_rowptr, csr_snd, csr_eid, H, C, g)
    N, hc = xp.shape[0], H * C
    E, fe = edge_attr.shape[0], edge_attr.shape[1]
    # d_xp is summed into with atomics; d_eh and d_pre keep zeros for the
    # edges outside the CSR; the kernel writes every row of d_a_i
    d_xp = torch.zeros((N, hc), device=xp.device, dtype=torch.float32)
    d_eh = torch.zeros((E, hc), device=xp.device, dtype=torch.float32)
    d_pre = torch.zeros((E, H), device=xp.device, dtype=torch.float32)
    d_a_i = torch.empty((N, H), device=xp.device, dtype=torch.float32)
    if N == 0:
        return d_xp, d_eh, d_pre, d_a_i
    blocks = _grid(lib, "triplet_bwd", xp, edge_attr, H, C)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        err = lib.triplet_bwd(
            xp.data_ptr(), a_i.data_ptr(), a_j.data_ptr(),
            edge_attr.data_ptr(), we.data_ptr(), wemat.data_ptr(),
            csr_rowptr.data_ptr(), csr_snd.data_ptr(), csr_eid.data_ptr(),
            g.data_ptr(), d_xp.data_ptr(), d_eh.data_ptr(),
            d_pre.data_ptr(), d_a_i.data_ptr(), N, hc, H, C, fe,
            float(slope), blocks, stream)
    if err != 0:
        raise RuntimeError(f"triplet_bwd launch failed with cudaError {err}")
    triplet_attention_bwd.launches += 1
    return d_xp, d_eh, d_pre, d_a_i


def _route(xp, plain, kernel):
    if xp.device.type == "cpu":
        return plain
    if xp.device.type != "cuda":
        raise ValueError(f"triplet_attention runs on cpu or cuda, not "
                         f"{xp.device}")
    return kernel


def triplet_attention_fwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                          csr_snd, csr_eid, num_heads: int, channels: int,
                          slope: float = 0.2):
    """The forward alone, not differentiable: CPU tensors run
    :func:`triplet_attention_plain`, CUDA tensors kernel A (float32
    tensors, int32 CSR, all contiguous, H*C up to 512) or raise."""
    fn = _route(xp, triplet_attention_plain, _launch_fwd)
    return fn(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
              csr_eid, num_heads, channels, slope)


def triplet_attention_bwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                          csr_snd, csr_eid, g, num_heads: int,
                          channels: int, slope: float = 0.2):
    """The backward: CPU tensors run :func:`triplet_attention_bwd_plain`,
    CUDA tensors kernel B (as kernel A takes them, g [N, H*C] float32
    contiguous) or raise.  d_xp is summed with float atomics on the card,
    so its sums run in another order on every call."""
    fn = _route(xp, triplet_attention_bwd_plain, _launch_bwd)
    return fn(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
              csr_eid, g, num_heads, channels, slope)


class _TripletAttention(torch.autograd.Function):
    """Forward through kernel A, backward through kernel B (or their
    plain versions on the CPU); then the small products of
    ``_backward`` (``triplet_fused.py:550-556``) as torch ops."""

    @staticmethod
    def forward(ctx, xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                csr_snd, csr_eid, num_heads, channels, slope):
        ctx.save_for_backward(xp, a_i, a_j, edge_attr, we, wemat,
                              csr_rowptr, csr_snd, csr_eid)
        ctx.widths = (num_heads, channels, slope)
        return triplet_attention_fwd(xp, a_i, a_j, edge_attr, we, wemat,
                                     csr_rowptr, csr_snd, csr_eid,
                                     num_heads, channels, slope)

    @staticmethod
    def backward(ctx, g):
        (xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
         csr_eid) = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_xp, d_eh, d_pre, d_a_i = triplet_attention_bwd(
            xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
            csr_eid, g.contiguous(), *ctx.widths)
        d_a_j = d_edge_attr = d_we = d_wemat = None
        if need[2]:
            d_a_j = torch.zeros_like(a_j).index_add_(
                0, csr_snd.long(), d_pre[csr_eid.long()])
        if need[3]:
            d_edge_attr = d_eh @ we.T
        if need[4]:
            d_we = edge_attr.T @ d_eh
        if need[5]:
            # eh.T @ d_pre with eh = edge_attr @ we, without forming eh
            d_wemat = we.T @ (edge_attr.T @ d_pre)
        return (d_xp, d_a_i, d_a_j, d_edge_attr, d_we, d_wemat,
                None, None, None, None, None, None)


def triplet_attention(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                      csr_snd, csr_eid, num_heads: int, channels: int,
                      slope: float = 0.2):
    """Fused TripletMessage attention-aggregation, differentiable in xp,
    a_i, a_j, edge_attr, we and wemat.

    Arguments as for :func:`triplet_attention_plain`.  CPU tensors run
    the plain versions; CUDA tensors run kernels A and B or raise."""
    return _TripletAttention.apply(xp, a_i, a_j, edge_attr, we, wemat,
                                   csr_rowptr, csr_snd, csr_eid, num_heads,
                                   channels, slope)


triplet_attention.launches = 0
triplet_attention_bwd.launches = 0
