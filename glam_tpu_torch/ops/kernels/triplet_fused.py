"""Fused TripletMessage attention forward: the CUDA kernel and its plain
torch version.

The kernel (``glam_tpu_torch/csrc/triplet_fused.cu``) replaces the Pallas
TPU kernel ``_fwd_kernel`` of the JAX package
(``glam_tpu/ops/pallas/triplet_fused.py:236``).  It walks a
receiver-sorted CSR of the real edges, one warp per receiver row, with an
online segment softmax, so it reads each real edge once and writes each
output row once.  It is bounded by memory traffic.

``triplet_attention`` takes CPU tensors to ``triplet_attention_plain``
and CUDA tensors to the kernel; on a CUDA tensor it launches the kernel
or raises.  ``triplet_attention.launches`` counts kernel launches.

Inference only: the backward kernel and its ``autograd.Function`` come
with the training slice.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import segment_softmax, segment_sum
from . import build

_SMEM_LIMIT = 48 * 1024   # shared memory without an opt-in attribute


def triplet_attention_plain(xp, a_i, a_j, edge_attr, we, wemat,
                            csr_rowptr, csr_snd, csr_eid, num_heads: int,
                            channels: int, slope: float = 0.2):
    """The kernel's function in plain torch (PyG segment-softmax
    semantics: max shift, +1e-16 in the denominator, 0 for empty rows).

    xp [N, H*C] head-major, a_i/a_j [N, H], edge_attr [E, Fe] raw edge
    features in original edge order, we [Fe, H*C], wemat [H*C, H]
    (a_e = (edge_attr @ we) @ wemat), and the receiver-sorted CSR of the
    real edges: csr_rowptr [N+1], csr_snd [E_real], csr_eid [E_real]
    (int32).  Returns [N, H*C]."""
    N = xp.shape[0]
    counts = (csr_rowptr[1:] - csr_rowptr[:-1]).long()
    rcv = torch.repeat_interleave(
        torch.arange(N, device=xp.device), counts,
        output_size=csr_snd.shape[0])
    snd = csr_snd.long()
    eh = edge_attr[csr_eid.long()] @ we                       # [E, H*C]
    pre = a_i[rcv] + eh @ wemat + a_j[snd]                    # [E, H]
    pre = torch.where(pre >= 0, pre, slope * pre)
    alpha = segment_softmax(pre, rcv, N)
    alpha_full = alpha.repeat_interleave(channels, dim=1)
    return segment_sum(alpha_full * eh * xp[snd], rcv, N)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("triplet_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.triplet_fused_fwd.argtypes = ([ptr] * 10 + [i32] * 5
                                      + [ctypes.c_float, i32, ptr])
    lib.triplet_fused_fwd.restype = i32
    for fn in ("max_hc", "max_heads", "warps_per_block"):
        getattr(lib, f"triplet_fused_{fn}").argtypes = []
        getattr(lib, f"triplet_fused_{fn}").restype = i32
    lib.triplet_fused_blocks_per_sm.argtypes = [i32] * 4
    lib.triplet_fused_blocks_per_sm.restype = i32
    lib.triplet_fused_smem_bytes.argtypes = [i32] * 3
    lib.triplet_fused_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _resident_blocks(dev, hc, heads, channels, fe) -> int:
    """Blocks of the kernel that fit on the card at once: the grid, so
    that every block is resident and each warp walks many rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = _lib().triplet_fused_blocks_per_sm(hc, heads, channels, fe)
    return sms * max(per_sm, 1)


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


def _launch(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
            csr_eid, num_heads, channels, slope):
    H, C = int(num_heads), int(channels)
    N, hc = xp.shape[0], H * C
    E, fe = edge_attr.shape[0], edge_attr.shape[1]
    E_real = csr_snd.shape[0]
    dev, f32, i32 = xp.device, torch.float32, torch.int32
    for name, t, dtype, shape in (
            ("xp", xp, f32, (N, hc)), ("a_i", a_i, f32, (N, H)),
            ("a_j", a_j, f32, (N, H)), ("edge_attr", edge_attr, f32, (E, fe)),
            ("we", we, f32, (fe, hc)), ("wemat", wemat, f32, (hc, H)),
            ("csr_rowptr", csr_rowptr, i32, (N + 1,)),
            ("csr_snd", csr_snd, i32, (E_real,)),
            ("csr_eid", csr_eid, i32, (E_real,))):
        _check(name, t, dev, dtype, shape)
    lib = _lib()
    limits = {"H*C": (hc, lib.triplet_fused_max_hc()),
              "heads": (H, lib.triplet_fused_max_heads()),
              "shared memory bytes": (lib.triplet_fused_smem_bytes(hc, H, fe),
                                      _SMEM_LIMIT)}
    for what, (got, most) in limits.items():
        if got > most:
            raise ValueError(f"triplet_attention kernel: {what} = {got} "
                             f"exceeds its maximum of {most}")
    out = torch.empty((N, hc), device=dev, dtype=f32)
    if N == 0:
        return out
    blocks = min(-(-N // lib.triplet_fused_warps_per_block()),
                 _resident_blocks(dev, hc, H, C, fe))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
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


def triplet_attention(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                      csr_snd, csr_eid, num_heads: int, channels: int,
                      slope: float = 0.2):
    """Fused TripletMessage attention-aggregation (forward only).

    Arguments as for :func:`triplet_attention_plain`.  CPU tensors run
    the plain version; CUDA tensors run the kernel (float32 tensors,
    int32 CSR, all contiguous, H*C up to 512) or raise."""
    if xp.device.type == "cpu":
        return triplet_attention_plain(xp, a_i, a_j, edge_attr, we, wemat,
                                       csr_rowptr, csr_snd, csr_eid,
                                       num_heads, channels, slope)
    if xp.device.type != "cuda":
        raise ValueError(f"triplet_attention runs on cpu or cuda, not "
                         f"{xp.device}")
    return _launch(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                   csr_eid, num_heads, channels, slope)


triplet_attention.launches = 0
