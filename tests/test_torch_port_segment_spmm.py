"""The plain versions of kernel C (segment softmax + SpMM) against the JAX
package: ``segment_softmax_spmm_plain`` against the Pallas
``fused_segment_softmax_spmm`` run in interpret mode (with its host
``pack_blocks``) and against ``segment_softmax_spmm_reference``, at that
kernel's test tolerance (rtol 1e-4, atol 1e-5, tests/test_pallas.py);
the plain backward and the ``autograd.Function`` on the CPU against
``jax.vjp`` of the reference at rtol 5e-4 (float32 sums in another order;
the softmax backward subtracts a row sum, which cancels), and
``gradcheck`` of the Function in float64."""
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
    segment_softmax_spmm, segment_softmax_spmm_bwd,
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
                                     *_csr(rcv, R)).numpy()
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
    got = segment_softmax_spmm_plain(torch.from_numpy(logits),
                                     torch.from_numpy(values), rowptr,
                                     idx).numpy()
    want = np.asarray(segment_softmax_spmm_reference(
        jnp.asarray(logits[:len(rcv)]), jnp.asarray(values[:len(rcv)]),
        jnp.asarray(rcv), 9))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    d_logits, d_values = segment_softmax_spmm_bwd_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx,
        torch.ones(9, 8))
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
    plain = segment_softmax_spmm_bwd_plain(
        torch.from_numpy(logits), torch.from_numpy(values), rowptr, idx,
        torch.from_numpy(g))
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
                                                       rowptr, idx))
    assert segment_softmax_spmm.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        segment_softmax_spmm(logits.to("meta"), values.to("meta"), rowptr,
                             idx)
