"""The plain versions of kernel C (segment softmax + SpMM) against the JAX
package: ``segment_softmax_spmm_plain`` against the Pallas
``fused_segment_softmax_spmm`` run in interpret mode (with its host
``pack_blocks``) and against ``segment_softmax_spmm_reference``, at that
kernel's test tolerance (rtol 1e-4, atol 1e-5, tests/test_pallas.py);
the plain backward and the ``autograd.Function`` on the CPU against
``jax.vjp`` of the reference at rtol 5e-4 (float32 sums in another order;
the softmax backward subtracts a row sum, which cancels), and
``gradcheck`` of the Function in float64.  The plain forward's row
statistics and the plain backward that takes them (with the forward's
output) against the Pallas kernel and ``jax.vjp`` at rtol 1e-5 / atol
2e-5.  What of the CUDA kernels' work layout the CPU can check: the
warps per block, the depth of the warp-wide row search, and the block
plan against the CSR (which block writes each row, which rows cross
blocks, and that each block holds at most the two crossing states and
the one ticket the wrapper makes room for); the kernels themselves are
checked on the card (``tests/test_torch_port_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glam_tpu.ops.pallas.segment_mxu import (fused_segment_softmax_spmm,
                                             pack_blocks,
                                             segment_softmax_spmm_reference)
from glam_tpu_torch.data.graph import receiver_csr
from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
    block_warps, segment_softmax_spmm, segment_softmax_spmm_bwd,
    segment_softmax_spmm_bwd_plain, segment_softmax_spmm_plain)


def _receivers(rng, case):
    """Receivers of the entries, in any order, and the row count: random
    rows of 1-12 entries with 10 empty rows between and after them, and
    for 'long' one row of 250 entries (the Pallas packing takes at most
    256 per row)."""
    lens = rng.randint(1, 13, 60)
    lens[[3, 17, 40]] = 0
    if case == "long":
        lens[25] = 250
    lens = np.concatenate([lens, np.zeros(7, lens.dtype)])
    rcv = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    return rng.permutation(rcv).astype(np.int32), len(lens)


def _inputs(rng, M, H, C, case, dtype=np.float32):
    logits = rng.randn(M, H) * 3
    if case == "spike":
        logits[rng.randint(M)] = 120.0
    return logits.astype(dtype), rng.randn(M, H * C).astype(dtype)


def _csr(rcv, R):
    rowptr, _, idx = receiver_csr(np.zeros_like(rcv), rcv, R)
    return torch.from_numpy(rowptr), torch.from_numpy(idx)


CASES = ["random", "spike", "long"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("heads,channels", [(1, 8), (3, 16)])
def test_plain_matches_pallas_and_reference(case, heads, channels):
    rng = np.random.RandomState(0)
    rcv, R = _receivers(rng, case)
    logits, values = _inputs(rng, len(rcv), heads, channels, case)
    got = segment_softmax_spmm_plain(torch.from_numpy(logits),
                                     torch.from_numpy(values),
                                     *_csr(rcv, R))[0].numpy()
    want = np.asarray(segment_softmax_spmm_reference(
        jnp.asarray(logits), jnp.asarray(values), jnp.asarray(rcv), R))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    empty = np.bincount(rcv, minlength=R) == 0
    assert empty.sum() == 10 and (got[empty] == 0).all()
    perm, local, starts, mask = pack_blocks(rcv, R)
    pallas = np.asarray(fused_segment_softmax_spmm(
        jnp.asarray(logits), jnp.asarray(values), jnp.asarray(perm),
        jnp.asarray(local), jnp.asarray(starts), jnp.asarray(mask), R,
        heads, channels, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)


def test_plain_matches_reference_on_a_long_row_and_unlisted_entries():
    """A row of 3,000 entries (past the Pallas packing's 256) and entries
    that no CSR slot lists, which take no part in any row."""
    rng = np.random.RandomState(1)
    rcv = np.concatenate([np.full(3000, 2), rng.randint(0, 9, 200)])
    rcv = rng.permutation(rcv).astype(np.int32)
    logits, values = _inputs(rng, len(rcv) + 5, 2, 4, "spike")
    rowptr, idx = _csr(rcv, 9)
    fwd = segment_softmax_spmm_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx)
    got = fwd[0].numpy()
    want = np.asarray(segment_softmax_spmm_reference(
        jnp.asarray(logits[:len(rcv)]), jnp.asarray(values[:len(rcv)]),
        jnp.asarray(rcv), 9))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    d_logits, d_values = segment_softmax_spmm_bwd_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx,
        *fwd, torch.ones(9, 8))
    assert (d_logits[len(rcv):] == 0).all()
    assert (d_values[len(rcv):] == 0).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("heads,channels", [(1, 8), (3, 16)])
def test_backward_matches_jax_vjp(case, heads, channels):
    rng = np.random.RandomState(2)
    rcv, R = _receivers(rng, case)
    logits, values = _inputs(rng, len(rcv), heads, channels, case)
    g = rng.randn(R, heads * channels).astype(np.float32)
    rowptr, idx = _csr(rcv, R)

    def reference(lg, v):
        return segment_softmax_spmm_reference(lg, v, jnp.asarray(rcv), R)

    _, vjp = jax.vjp(reference, jnp.asarray(logits), jnp.asarray(values))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    stats = segment_softmax_spmm_plain(torch.from_numpy(logits),
                                       torch.from_numpy(values), rowptr,
                                       idx)
    plain = segment_softmax_spmm_bwd_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx,
        *stats, torch.from_numpy(g))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (logits, values)]
    before = segment_softmax_spmm_bwd.launches
    segment_softmax_spmm(*leaves, rowptr, idx).backward(torch.from_numpy(g))
    assert segment_softmax_spmm_bwd.launches == before   # none on the CPU
    for name, p, a, w in zip(("d_logits", "d_values"), plain, leaves, want):
        assert torch.equal(a.grad, p), name
        np.testing.assert_allclose(p.numpy(), w, rtol=5e-4, atol=1e-6,
                                   err_msg=name)


def test_gradcheck_float64():
    rcv = np.asarray([0, 2, 2, 0, 2, 3, 3, 3], np.int32)
    rng = np.random.RandomState(3)
    logits, values = _inputs(rng, len(rcv) + 1, 2, 3, "random", np.float64)
    rowptr, idx = _csr(rcv, 5)
    inputs = tuple(torch.from_numpy(a).requires_grad_(True)
                   for a in (logits, values))
    assert torch.autograd.gradcheck(
        lambda lg, v: segment_softmax_spmm(lg, v, rowptr, idx), inputs,
        eps=1e-6, atol=1e-6)


def test_wrapper_dispatch():
    rng = np.random.RandomState(4)
    rcv, R = _receivers(rng, "random")
    logits, values = (torch.from_numpy(a) for a in
                      _inputs(rng, len(rcv), 1, 8, "random"))
    rowptr, idx = _csr(rcv, R)
    before = segment_softmax_spmm.launches
    got = segment_softmax_spmm(logits, values, rowptr, idx)
    assert torch.equal(got, segment_softmax_spmm_plain(logits, values,
                                                       rowptr, idx)[0])
    assert segment_softmax_spmm.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment_softmax_spmm(logits.to("meta"), values.to("meta"), rowptr,
                             idx)


# ------------------------------------------------------- row statistics
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("heads,channels", [(1, 8), (3, 16), (2, 3)])
def test_plain_with_stats_matches_pallas_and_vjp(case, heads, channels):
    """The plain forward's output and row statistics and the plain
    backward that takes those statistics against the Pallas kernel in
    interpret mode and ``jax.vjp`` of its oracle, at rtol 1e-5 / atol
    2e-5 (float32 sums in another order)."""
    rng = np.random.RandomState(5)
    rcv, R = _receivers(rng, case)
    logits, values = _inputs(rng, len(rcv), heads, channels, case)
    g = rng.randn(R, heads * channels).astype(np.float32)
    rowptr, idx = _csr(rcv, R)
    out, row_max, row_inv = segment_softmax_spmm_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx)
    perm, local, starts, mask = pack_blocks(rcv, R)
    pallas = np.asarray(fused_segment_softmax_spmm(
        jnp.asarray(logits), jnp.asarray(values), jnp.asarray(perm),
        jnp.asarray(local), jnp.asarray(starts), jnp.asarray(mask), R,
        heads, channels, interpret=True))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-5, atol=2e-5)
    # the statistics: each row's max and 1 / (sum of exp + 1e-16); 0, 0
    # for an empty row
    counts = np.bincount(rcv, minlength=R)
    for r in range(R):
        x = logits[rcv == r].astype(np.float64)
        if not len(x):
            assert (row_max[r] == 0).all() and (row_inv[r] == 0).all()
            continue
        np.testing.assert_array_equal(row_max[r].numpy(), x.max(0))
        want = 1 / (np.exp(x - x.max(0)).sum(0) + 1e-16)
        np.testing.assert_allclose(row_inv[r].numpy(), want, rtol=1e-5)
    assert (counts == 0).sum() == 10

    def reference(lg, v):
        return segment_softmax_spmm_reference(lg, v, jnp.asarray(rcv), R)

    _, vjp = jax.vjp(reference, jnp.asarray(logits), jnp.asarray(values))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    got = segment_softmax_spmm_bwd_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx,
        out, row_max, row_inv, torch.from_numpy(g))
    for name, a, w in zip(("d_logits", "d_values"), got, want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-5, atol=2e-5,
                                   err_msg=name)


# -------------------------------------------- the kernels' work layout
CHUNK = 32


def _warp_find_row(rowptr, s, lo):
    """``warp_find_row``: the largest r in [lo, R) with rowptr[r] <= s,
    32 pivots a round.  Returns (r, rounds)."""
    hi, rounds = len(rowptr) - 1, 0
    while hi - lo > 1:
        step = -(-(hi - lo) // 32)
        p = lo + np.arange(32) * step
        le = (p < hi) & (rowptr[np.minimum(p, hi)] <= s)
        lo += int(np.flatnonzero(le).max()) * step
        hi = min(hi, lo + step)
        rounds += 1
    return lo, rounds


def _layout_csr(case, rng):
    """(rowptr, idx, M) for the layout's cases."""
    if case == "empty_runs":      # rows of 0-6 entries, runs of 40-200 empty
        lens = rng.randint(0, 7, 300)
        for at in (20, 90, 200):
            lens[at:at + rng.randint(40, 200)] = 0
    elif case == "spanning":      # a row over 3+ blocks, one on a boundary
        lens = rng.randint(1, 30, 60)
        lens[10] = 900
        lens[40] = 256
    elif case == "empty_at_end":  # 200 empty rows in a row, then at S
        lens = np.concatenate([rng.randint(1, 9, 100), np.zeros(200, int),
                               rng.randint(1, 9, 50), np.zeros(37, int)])
    else:                         # "unlisted": S < M
        lens = rng.randint(0, 12, 150)
    rowptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=rowptr[1:])
    S = int(rowptr[-1])
    M = S + (23 if case == "unlisted" else 0)
    return rowptr, rng.permutation(M)[:S], M


@pytest.mark.parametrize("case", ["empty_runs", "spanning", "empty_at_end",
                                  "unlisted"])
def test_row_search_model_matches_the_csr(case):
    """The warp-wide search finds each chunk's first row in at most
    ceil(log32 R) rounds, whatever the runs of empty rows."""
    rowptr, _, _ = _layout_csr(case, np.random.RandomState(6))
    R, S = len(rowptr) - 1, int(rowptr[-1])
    row_of = np.searchsorted(rowptr, np.arange(S), "right") - 1
    depth = int(np.ceil(np.log(R) / np.log(32)))
    for c0 in range(0, S, CHUNK):
        r, rounds = _warp_find_row(rowptr, c0, 0)
        assert r == row_of[c0] and rounds <= depth


def _block_plan(rowptr, slots, block_slots):
    """Which block of the forward kernel writes each row, for a CSR over
    ``slots`` slots cut into blocks of ``block_slots``: (writer [R],
    spans [K, 3]).  A non-empty row is written by the block of its last
    slot when it lies in one block, else by whichever of its blocks takes
    its last ticket; ``spans`` lists those rows as (row, first block, last
    block).  An empty row is written by the block whose share of the rows
    (``ceil(R / blocks)`` each, in order) holds it."""
    R = len(rowptr) - 1
    blocks = max(1, -(-slots // block_slots))
    beg, end = rowptr[:-1], rowptr[1:]
    empty = end == beg
    first = beg // block_slots
    last = np.maximum(end - 1, 0) // block_slots
    writer = np.where(empty, np.arange(R) // max(1, -(-R // blocks)), last)
    span = ~empty & (last > first)
    writer[span] = -1
    return writer, np.stack([np.flatnonzero(span), first[span],
                             last[span]], 1)


def test_block_warps_spread_the_blocks():
    """At the trainer's shapes blocks of 1-2 warps, one per SM of an
    H100's 132; at the serving shapes 8; 8 in a forward whose rows
    average more than 32 slots (the readouts' graph rows)."""
    assert block_warps(2264, 132) == 1 and block_warps(4832, 132) == 2
    assert block_warps(7096, 132) == 2 and block_warps(50688, 132) == 8
    assert block_warps(0, 132) == 1 and block_warps(33, 132) == 1
    assert block_warps(4832, 132, rows=2264) == 2        # Light's edges
    assert block_warps(2264, 132, rows=33) == 8          # Set2Set's graphs
    assert block_warps(16904, 132, rows=129) == 8
    assert block_warps(64, 132, rows=2) == 1


@pytest.mark.parametrize("warps", [1, 8])
@pytest.mark.parametrize("case", ["empty_runs", "spanning", "empty_at_end",
                                  "unlisted"])
def test_block_plan_matches_the_csr(case, warps):
    """The forward's plan names one block to write each row: empty rows
    from the row shares (a run of 200 and those at rowptr == S included),
    the rows inside one block that block, and marks the rows that cross
    blocks.  Each block holds at most two crossing rows (the wrapper's two
    state slots per block) and is the first block of at most one (its one
    ticket)."""
    rng = np.random.RandomState(7)
    rowptr, idx, M = _layout_csr(case, rng)
    R, S, block = len(rowptr) - 1, len(idx), CHUNK * warps
    writer, spans = _block_plan(rowptr, S, block)
    empty = np.diff(rowptr) == 0
    nb = max(1, -(-S // block))
    assert ((writer >= 0) | ~empty).all() and (writer < nb).all()
    np.testing.assert_array_equal(np.diff(writer[empty]) >= 0, True)
    row_of = np.searchsorted(rowptr, np.arange(S), "right") - 1
    blk = np.arange(S) // block
    for r in np.flatnonzero(~empty):
        blocks = np.unique(blk[row_of == r])
        if len(blocks) == 1:
            assert writer[r] == blocks[0]
        else:
            assert writer[r] == -1 and r in spans[:, 0]
    crossing = np.zeros(nb, int)
    for _, bf, bl in spans:
        crossing[bf:bl + 1] += 1
    assert crossing.max(initial=0) <= 2
    assert np.bincount(spans[:, 1], minlength=nb).max() <= 1
    if case == "spanning":
        assert (spans[:, 2] - spans[:, 1] >= 3).any()
