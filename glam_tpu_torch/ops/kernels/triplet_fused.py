"""Fused TripletMessage attention: the CUDA kernels, their plain torch
versions and the ``autograd.Function`` around them.

Kernel A (``glam_tpu_torch/csrc/triplet_fused.cu``) is the forward; it
replaces the Pallas TPU kernel ``_fwd_kernel`` of the JAX package
(``glam_tpu/ops/pallas/triplet_fused.py:236``).  Kernel B
(``glam_tpu_torch/csrc/triplet_fused_bwd.cu``) is the backward; it
replaces ``_bwd_kernel`` (same file, :296).  Both take a receiver-sorted
CSR of the real edges: a row of 1-32 edges is one warp's, a longer row is
cut into 32-edge chunks over warps and merged in CSR order
(``csrc/triplet_common.cuh``); both are bounded by memory traffic.  The
CSR's slot arrays may be longer than its rows (a batch's, padded to the
edge budget: ``data/graph.py``): the slots past ``csr_rowptr[-1]`` belong
to no row, and the kernels read that count on the device, so a call's
grid and allocations follow the slot arrays' length alone and every batch
of a loader launches alike (a CUDA graph replays them); on the CPU the
wrappers cut them before the plain versions, which take the rows' slots.

Kernel B writes each edge's term of d_xp once, and the fixed-order CSR
sum (``segment_sum_csr``) adds them over the sender CSR, as it adds
d_pre into d_a_j: every output of the backward is the same on every
call.  The sender CSR is the batch's (``GraphBatch.snd_rowptr``,
``snd_eid``), or is built from the receiver CSR on the tensors' device
(:func:`sender_csr_of`) where the caller has none.  Either lists the
padded edges last: its first E_real = ``csr_rowptr[-1]`` slots are the
real edges (a batch's sends them from the last node, after its real
edges: ``data/graph.py``; :func:`sender_csr_of` puts the slots past
E_real last whichever node they name).  So both sums end at
``csr_rowptr[N:]``, a view read on the device, and kernel B leaves
d_xp's padded rows, which no sum reads, unwritten.

The forward also gives each row's softmax statistics, ``row_max`` [N, H]
and ``row_inv`` = 1 / (sum of exp + 1e-16) [N, H] (both 0 for an empty
row).  The backward takes them and the forward's output, whose dot with
the cotangent is the softmax backward's row sum, so it computes each
edge's gradient in one pass without recomputing the softmax; the
``autograd.Function`` keeps the inputs, the output and the statistics
between the two.

``triplet_attention`` is the differentiable op (the Function's
``apply``).  CPU tensors run the plain versions; CUDA tensors run the
kernels or raise.  ``triplet_attention.launches`` counts launches of
kernel A and ``triplet_attention_bwd.launches`` those of kernel B.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import csr_rows, index_sum, segments_of
from . import build, common
from .segment_sum_csr import segment_sum_csr, segment_sum_csr_plain

_EPS = 1e-16
_SMEM_LIMIT = 232448   # shared memory a block can use on Hopper


def _logits(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
            csr_eid, slope):
    """The CSR edges' rows, senders, projections eh [E, H*C] and raw and
    leaky-ReLU logits [E, H]."""
    rcv = csr_rows(csr_rowptr, csr_snd.shape[0])
    snd = csr_snd.long()
    eh = edge_attr[csr_eid.long()] @ we
    pre_raw = a_i[rcv] + eh @ wemat + a_j[snd]
    pre = torch.where(pre_raw >= 0, pre_raw, slope * pre_raw)
    return rcv, snd, eh, pre_raw, pre


def triplet_attention_plain(xp, a_i, a_j, edge_attr, we, wemat,
                            csr_rowptr, csr_snd, csr_eid, num_heads: int,
                            channels: int, slope: float = 0.2):
    """The forward kernel's function in plain torch (PyG segment-softmax
    semantics: max shift, +1e-16 in the denominator, 0 for empty rows).

    xp [N, H*C] head-major, a_i/a_j [N, H], edge_attr [E, Fe] raw edge
    features in original edge order, we [Fe, H*C], wemat [H*C, H]
    (a_e = (edge_attr @ we) @ wemat), and the receiver-sorted CSR of the
    real edges: csr_rowptr [N+1], csr_snd [E_real], csr_eid [E_real]
    (int32).  Returns (out [N, H*C], row_max [N, H], row_inv [N, H]): the
    rows' largest logit and 1 / (sum of exp(logit - max) + 1e-16), both 0
    for an empty row."""
    N, C = xp.shape[0], channels
    rcv, snd, eh, _, pre = _logits(xp, a_i, a_j, edge_attr, we, wemat,
                                   csr_rowptr, csr_snd, csr_eid, slope)
    row_max = pre.new_full((N, num_heads), -torch.inf).index_reduce_(
        0, rcv, pre, "amax", include_self=True)
    nonempty = (csr_rowptr[1:] > csr_rowptr[:-1])[:, None]
    row_max = torch.where(nonempty, row_max, torch.zeros_like(row_max))
    ex = torch.exp(pre - row_max[rcv])
    row_inv = torch.where(nonempty, 1.0 / (index_sum(ex, rcv, N) + _EPS),
                          torch.zeros_like(row_max))
    alpha = (ex * row_inv[rcv]).repeat_interleave(C, dim=1)
    out = index_sum(alpha * eh * xp[snd], rcv, N)
    return out, row_max, row_inv


def sender_csr_of(csr_snd, csr_eid, num_nodes: int, csr_rowptr):
    """The sender CSR of a receiver CSR's slots, built on their device:
    (rowptr [N+1], edge ids [slots]) int32, a sender's slots in slot
    order (a stable sort; no host synchronisation).  The slots at or past
    ``csr_rowptr[N]`` (padded edges, in no row) count as the last node's,
    whichever node they name: they come last, after every real edge, as
    the backward's sums need."""
    slot = torch.arange(csr_snd.shape[0], device=csr_snd.device,
                        dtype=csr_snd.dtype)
    csr_snd = torch.where(slot < csr_rowptr[num_nodes:], csr_snd,
                          num_nodes - 1)
    seg = segments_of(csr_snd, num_nodes)
    return seg.rowptr, csr_eid.index_select(0, seg.perm)


def triplet_attention_bwd_plain(xp, a_i, a_j, edge_attr, we, wemat,
                                csr_rowptr, csr_snd, csr_eid, out, row_max,
                                row_inv, g, num_heads: int, channels: int,
                                slope: float = 0.2, snd_rowptr=None,
                                snd_eid=None):
    """The backward kernel's function in plain torch, written out as the
    kernel computes it (not by autograd).

    Arguments as for :func:`triplet_attention_plain`, plus its results
    out, row_max and row_inv and the output's cotangent g [N, H*C].
    Returns (d_xp [N, H*C], d_eh [E, H*C], d_pre [E, H], d_a_i [N, H]):
    d_eh and d_pre are the cotangents of the edge projection
    eh = edge_attr @ we and of the attention logit before the leaky ReLU,
    in original edge order, zero for edges outside the CSR (padding).
    d_xp sums each edge's term over the sender CSR ``snd_rowptr``,
    ``snd_eid`` (:func:`sender_csr_of` of the CSR when None; the padded
    edges last), up to the real edges' count ``csr_rowptr[N:]``."""
    H, C = num_heads, channels
    N, E = xp.shape[0], edge_attr.shape[0]
    rcv, snd, eh, pre_raw, pre = _logits(xp, a_i, a_j, edge_attr, we,
                                         wemat, csr_rowptr, csr_snd,
                                         csr_eid, slope)
    alpha = torch.exp(pre - row_max[rcv]) * row_inv[rcv]      # [E, H]
    xj, grcv = xp[snd], g[rcv]
    dvalues = alpha.repeat_interleave(C, dim=1) * grcv        # [E, H*C]
    dalpha = (eh * xj * grcv).view(-1, H, C).sum(-1)          # [E, H]
    # softmax backward: dpre = alpha * (dalpha - sum_row alpha * dalpha),
    # the row sum being <g[r], out[r]> per head, summed in float64: dpre
    # subtracts it from dalpha, which cancels digits
    row_d = (g.double() * out.double()).view(N, H, C).sum(-1)
    row_d = row_d.to(g.dtype)[rcv]
    dpre = alpha * (dalpha - row_d)
    dpre = dpre * torch.where(pre_raw >= 0, 1.0, slope).to(dpre.dtype)
    eid = csr_eid.long()
    d_xpe = xp.new_zeros((E, H * C))
    d_xpe[eid] = dvalues * eh                                 # to senders
    if snd_rowptr is None:
        snd_rowptr, snd_eid = sender_csr_of(csr_snd, csr_eid, N,
                                            csr_rowptr)
    d_xp = segment_sum_csr_plain(d_xpe, snd_rowptr, snd_eid,
                                 limit=csr_rowptr[N:])
    d_eh = xp.new_zeros((E, H * C))
    d_eh[eid] = dvalues * xj + dpre @ wemat.T
    d_pre = xp.new_zeros((E, H))
    d_pre[eid] = dpre
    return d_xp, d_eh, d_pre, index_sum(dpre, rcv, N)


@functools.cache
def _bind(name: str, prefix: str, launch: str, n_ptrs: int, n_ints: int):
    """Load kernel source ``name`` and type its launch ``launch``
    (``n_ptrs`` pointers, ``n_ints`` ints, slope, vec, stream).  Returns
    (the launch, (its largest H*C, its most heads, its most edge features,
    its shared-memory query))."""
    lib = build.load(name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, launch)
    fn.argtypes = [ptr] * n_ptrs + [i32] * n_ints + [ctypes.c_float, i32,
                                                      ptr]
    fn.restype = i32
    limits = []
    for q in ("max_hc", "max_heads", "max_fe"):
        query = getattr(lib, f"{prefix}_{q}")
        query.argtypes, query.restype = [], i32
        limits.append(query())
    smem = getattr(lib, f"{prefix}_smem_bytes")
    smem.argtypes, smem.restype = [i32] * 3, ctypes.c_longlong
    return fn, (*limits, smem)


def _check_inputs(limits, xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                  csr_snd, csr_eid, H, C, extra=()):
    """Raise on what the kernels do not take: devices, dtypes, shapes,
    contiguity and the widths' limits.  ``extra`` holds (name, tensor,
    shape) of further float32 inputs."""
    N, hc = xp.shape[0], H * C
    E, fe = edge_attr.shape[0], edge_attr.shape[1]
    dev, f32, i32 = xp.device, torch.float32, torch.int32
    checks = [("xp", xp, f32, (N, hc)), ("a_i", a_i, f32, (N, H)),
              ("a_j", a_j, f32, (N, H)), ("edge_attr", edge_attr, f32, (E, fe)),
              ("we", we, f32, (fe, hc)), ("wemat", wemat, f32, (hc, H)),
              ("csr_rowptr", csr_rowptr, i32, (N + 1,)),
              ("csr_snd", csr_snd, i32, (csr_snd.shape[0],)),
              ("csr_eid", csr_eid, i32, (csr_snd.shape[0],))]
    checks += [(name, t, f32, shape) for name, t, shape in extra]
    for name, t, dtype, shape in checks:
        common.check(name, t, dev, dtype, shape)
    max_hc, max_heads, max_fe, smem = limits
    for what, got, most in (("H*C", hc, max_hc), ("heads", H, max_heads),
                            ("edge features", fe, max_fe),
                            ("shared memory bytes", smem(hc, H, fe),
                             _SMEM_LIMIT)):
        if got > most:
            raise ValueError(f"triplet_attention kernel: {what} = {got} "
                             f"exceeds its maximum of {most}")
    if csr_snd.shape[0] > E:
        raise ValueError(f"triplet_attention kernel: {csr_snd.shape[0]} "
                         f"CSR edges but {E} edge features")


def _launch_fwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                csr_eid, num_heads, channels, slope):
    H, C = int(num_heads), int(channels)
    launch, limits = _bind("triplet_fused", "triplet_fused",
                           "triplet_fused_fwd", 14, 6)
    _check_inputs(limits, xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                  csr_snd, csr_eid, H, C)
    dev, N, hc, fe = xp.device, xp.shape[0], H * C, edge_attr.shape[1]
    S = csr_snd.shape[0]
    chunks = -(-S // 32)
    # one allocation: out [N, H*C], row_max, row_inv [N, H] and the long
    # rows' partial results [chunks, 2, sw], each part 16-byte aligned
    sizes = [common.up4(N * hc), common.up4(N * H), common.up4(N * H),
             chunks * 2 * common.up4(hc + 2 * H)]
    buf = torch.empty((sum(sizes),), device=dev, dtype=torch.float32)
    out, row_max, row_inv, part = buf.split(sizes)
    out, row_max, row_inv = (out[:N * hc].view(N, hc),
                             row_max[:N * H].view(N, H),
                             row_inv[:N * H].view(N, H))
    if N == 0:
        return out, row_max, row_inv
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = common.tickets(dev, stream, chunks)
    vec = int(C % 4 == 0 and common.aligned(xp, buf))
    common.run(launch, "triplet_fused_fwd", dev, (
        xp.data_ptr(), a_i.data_ptr(), a_j.data_ptr(), edge_attr.data_ptr(),
        we.data_ptr(), wemat.data_ptr(), csr_rowptr.data_ptr(),
        csr_snd.data_ptr(), csr_eid.data_ptr(), out.data_ptr(),
        row_max.data_ptr(), row_inv.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), N, S, hc, H, C, fe, float(slope), vec), stream)
    triplet_attention.launches += 1
    return out, row_max, row_inv


def _launch_bwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                csr_eid, out, row_max, row_inv, g, num_heads, channels,
                slope, snd_rowptr=None, snd_eid=None):
    H, C = int(num_heads), int(channels)
    launch, limits = _bind("triplet_fused_bwd", "triplet_bwd",
                           "triplet_bwd", 19, 7)
    N, hc = xp.shape[0], H * C
    _check_inputs(limits, xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                  csr_snd, csr_eid, H, C,
                  [("out", out, (N, hc)), ("row_max", row_max, (N, H)),
                   ("row_inv", row_inv, (N, H)), ("g", g, (N, hc))])
    dev, S = xp.device, csr_snd.shape[0]
    E, fe = edge_attr.shape[0], edge_attr.shape[1]
    chunks = -(-S // 32)
    # the kernel writes every row of d_eh (padded edges' rows too), d_pre
    # and d_a_i, and of d_xpe the real edges', all the sum reads: one
    # allocation, no fill, d_xpe and d_eh first so that they are 16-byte
    # aligned
    sizes = [common.up4(E * hc), common.up4(E * hc), common.up4(E * H),
             common.up4(N * H), chunks * 2 * 8]
    buf = torch.empty((sum(sizes),), device=dev, dtype=torch.float32)
    d_xpe, d_eh, d_pre, d_a_i, part = buf.split(sizes)
    d_xpe, d_eh = d_xpe[:E * hc].view(E, hc), d_eh[:E * hc].view(E, hc)
    d_pre, d_a_i = d_pre[:E * H].view(E, H), d_a_i[:N * H].view(N, H)
    if N == 0:
        d_eh.zero_()
        d_pre.zero_()
        return xp.new_zeros((N, hc)), d_eh, d_pre, d_a_i
    if snd_rowptr is None:
        snd_rowptr, snd_eid = sender_csr_of(csr_snd, csr_eid, N,
                                            csr_rowptr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = common.tickets(dev, stream, chunks)
    vec = int(C % 4 == 0 and common.aligned(xp, g, out, buf))
    common.run(launch, "triplet_bwd", dev, (
        xp.data_ptr(), a_i.data_ptr(), a_j.data_ptr(), edge_attr.data_ptr(),
        we.data_ptr(), wemat.data_ptr(), csr_rowptr.data_ptr(),
        csr_snd.data_ptr(), csr_eid.data_ptr(), out.data_ptr(),
        row_max.data_ptr(), row_inv.data_ptr(), g.data_ptr(),
        d_xpe.data_ptr(), d_eh.data_ptr(), d_pre.data_ptr(),
        d_a_i.data_ptr(), part.data_ptr(), tickets.data_ptr(), N, S, E, hc,
        H, C, fe, float(slope), vec), stream)
    triplet_attention_bwd.launches += 1
    return (segment_sum_csr(d_xpe, snd_rowptr, snd_eid, csr_rowptr[N:]),
            d_eh, d_pre, d_a_i)


def _real_slots(plain):
    """``plain`` over the slots of the CSR's rows alone: a CSR padded to
    the batch's edge budget is cut at ``csr_rowptr[-1]`` (a host read,
    free on the CPU)."""
    def over_rows(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
                  csr_eid, *rest):
        n = int(csr_rowptr[-1])
        return plain(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                     csr_snd[:n], csr_eid[:n], *rest)
    return over_rows


def _route(xp, plain, kernel):
    if xp.device.type == "cpu":
        return _real_slots(plain)
    if xp.device.type != "cuda":
        raise ValueError(f"triplet_attention runs on cpu or cuda, not "
                         f"{xp.device}")
    return kernel


def triplet_attention_fwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                          csr_snd, csr_eid, num_heads: int, channels: int,
                          slope: float = 0.2):
    """The forward alone, not differentiable: (out, row_max, row_inv).
    The CSR's slot arrays may run past ``csr_rowptr[-1]`` (padded to the
    edge budget).  CPU tensors run :func:`triplet_attention_plain` over the
    rows' slots, CUDA tensors kernel A (float32 tensors, int32 CSR, all
    contiguous, H up to 8 and H*C up to 512) or raise."""
    fn = _route(xp, triplet_attention_plain, _launch_fwd)
    return fn(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
              csr_eid, num_heads, channels, slope)


def triplet_attention_bwd(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                          csr_snd, csr_eid, out, row_max, row_inv, g,
                          num_heads: int, channels: int, slope: float = 0.2,
                          snd_rowptr=None, snd_eid=None):
    """The backward: CPU tensors run :func:`triplet_attention_bwd_plain`
    over the rows' slots, CUDA tensors kernel B (as kernel A takes them;
    the forward's out, row_max and row_inv and g [N, H*C], float32
    contiguous) or raise.

    The kernel relies on the invariant that ``pad_graphs`` keeps: the
    real edges come first and ``csr_eid``'s first E_real = csr_rowptr[-1]
    slots are a permutation of [0, E_real), so that it writes every real
    edge's rows of d_eh and d_pre and zeroes the padded edges' rows
    [E_real, E) itself.  d_xp is each edge's term summed over the sender
    CSR ``snd_rowptr``, ``snd_eid`` (the CSR's own, :func:`sender_csr_of`,
    when None) by ``segment_sum_csr``: every output is the same on every
    call.  The sender CSR lists the padded edges last, so the sum ends at
    the real edges (``csr_rowptr[N:]``) and d_xp's padded rows go
    unwritten."""
    fn = _route(xp, triplet_attention_bwd_plain, _launch_bwd)
    return fn(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
              csr_eid, out, row_max, row_inv, g, num_heads, channels, slope,
              snd_rowptr, snd_eid)


class _TripletAttention(torch.autograd.Function):
    """Forward through kernel A, backward through kernel B (or their
    plain versions on the CPU); then the small products of
    ``_backward`` (``triplet_fused.py:550-556``) as torch ops."""

    @staticmethod
    def forward(ctx, xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                csr_snd, csr_eid, num_heads, channels, slope, snd_rowptr,
                snd_eid):
        out, row_max, row_inv = triplet_attention_fwd(
            xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
            csr_eid, num_heads, channels, slope)
        if snd_rowptr is None:
            snd_rowptr, snd_eid = sender_csr_of(csr_snd, csr_eid,
                                                xp.shape[0], csr_rowptr)
        ctx.save_for_backward(xp, a_i, a_j, edge_attr, we, wemat,
                              csr_rowptr, csr_snd, csr_eid, out, row_max,
                              row_inv, snd_rowptr, snd_eid)
        ctx.widths = (num_heads, channels, slope)
        return out

    @staticmethod
    def backward(ctx, g):
        (xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd, csr_eid,
         out, row_max, row_inv, snd_rowptr, snd_eid) = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_xp, d_eh, d_pre, d_a_i = triplet_attention_bwd(
            xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr, csr_snd,
            csr_eid, out, row_max, row_inv, g.contiguous(), *ctx.widths,
            snd_rowptr, snd_eid)
        d_a_j = d_edge_attr = d_we = d_wemat = None
        if need[2]:
            # d_pre's rows by sender, in the sender CSR's order, up to
            # the real edges (d_pre's padded rows are zero)
            d_a_j = segment_sum_csr(d_pre, snd_rowptr, snd_eid,
                                    csr_rowptr[xp.shape[0]:])
        if need[3]:
            d_edge_attr = d_eh @ we.T
        if need[4]:
            d_we = edge_attr.T @ d_eh
        if need[5]:
            # eh.T @ d_pre with eh = edge_attr @ we, without forming eh
            d_wemat = we.T @ (edge_attr.T @ d_pre)
        return (d_xp, d_a_i, d_a_j, d_edge_attr, d_we, d_wemat,
                None, None, None, None, None, None, None, None)


def triplet_attention(xp, a_i, a_j, edge_attr, we, wemat, csr_rowptr,
                      csr_snd, csr_eid, num_heads: int, channels: int,
                      slope: float = 0.2, snd_rowptr=None, snd_eid=None):
    """Fused TripletMessage attention-aggregation, differentiable in xp,
    a_i, a_j, edge_attr, we and wemat.

    Arguments as for :func:`triplet_attention_plain`, and the sender CSR
    of every edge the backward sums d_xp and d_a_j over (the batch's
    ``snd_rowptr``, ``snd_eid``, which lists the padded edges last; built
    from the receiver CSR when None): both sums of the backward end at the
    real edges.  Returns out [N, H*C].  CPU tensors run the plain
    versions; CUDA tensors run kernels A and B or raise."""
    return _TripletAttention.apply(xp, a_i, a_j, edge_attr, we, wemat,
                                   csr_rowptr, csr_snd, csr_eid, num_heads,
                                   channels, slope, snd_rowptr, snd_eid)


triplet_attention.launches = 0
triplet_attention_bwd.launches = 0
