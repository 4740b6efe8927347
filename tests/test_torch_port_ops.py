"""Port segment ops and the plain version of the triplet-attention kernel
against the JAX package: ``triplet_attention_plain`` against both
``triplet_attention_reference`` and the Pallas ``fused_triplet_attention``
run in interpret mode, at that kernel's test tolerance (rtol 1e-4,
atol 1e-5); its row statistics (each row's largest logit and
1 / (sum of exp + 1e-16)) against the same computed with ``jax.ops`` from
the reference's logits, at rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glam_tpu.ops import segment as jax_segment
from glam_tpu.ops.pallas.triplet_fused import (fused_triplet_attention,
                                               pack_blocks2,
                                               triplet_attention_reference)
from glam_tpu_torch.data.graph import receiver_csr
from glam_tpu_torch.ops import segment as port_segment
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_plain)


def _random_batch(rng, n_graphs=20, max_n=30, isolated_tail=16,
                  hub_degree=300):
    """Contiguous small random graphs, an isolated-node tail (empty
    rows) and one receiver of high in-degree."""
    off, snd, rcv = 0, [], []
    for gi in range(n_graphs):
        n = rng.randint(4, max_n)
        e = rng.randint(3, 4 * n)
        snd.extend((rng.randint(0, n, e) + off).tolist())
        rcv.extend((rng.randint(0, n, e) + off).tolist())
        if gi == 0 and hub_degree:
            snd.extend((rng.randint(0, n, hub_degree) + off).tolist())
            rcv.extend([off + 1] * hub_degree)
        off += n
    return (np.asarray(snd, np.int32), np.asarray(rcv, np.int32),
            off + isolated_tail)


def _params(rng, N, E, H, C, Fe=4):
    w_e = rng.randn(H, C).astype(np.float32)
    wemat = np.zeros((H * C, H), np.float32)
    for h in range(H):
        wemat[h * C:(h + 1) * C, h] = w_e[h]
    return dict(
        xp=rng.randn(N, H * C).astype(np.float32),
        a_i=rng.randn(N, H).astype(np.float32),
        a_j=rng.randn(N, H).astype(np.float32),
        edge_attr=rng.randn(E, Fe).astype(np.float32),
        we=(rng.randn(Fe, H * C) * 0.3).astype(np.float32),
        wemat=wemat)


def _plain(p, snd, rcv, N, H, C):
    rowptr, csr_snd, csr_eid = receiver_csr(snd, rcv, N)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    return [a.numpy() for a in triplet_attention_plain(
        *t.values(), torch.from_numpy(rowptr), torch.from_numpy(csr_snd),
        torch.from_numpy(csr_eid), H, C)]


def _jax_stats(p, snd, rcv, N, H, slope=0.2):
    """Each row's largest logit and 1 / (sum of exp(logit - max) + 1e-16)
    from the reference's logits (``triplet_fused.py:568-576``), with
    ``jax.ops``; 0 and 0 for an empty row."""
    j = {k: jnp.asarray(v) for k, v in p.items()}
    pre = (j["a_i"][rcv] + (j["edge_attr"] @ j["we"]) @ j["wemat"]
           + j["a_j"][snd])
    pre = jnp.where(pre >= 0, pre, slope * pre)
    nonempty = (np.bincount(rcv, minlength=N) > 0)[:, None]
    m = jnp.where(nonempty, jax.ops.segment_max(pre, rcv, N), 0.0)
    total = jax.ops.segment_sum(jnp.exp(pre - m[rcv]), rcv, N)
    return (np.asarray(m),
            np.asarray(jnp.where(nonempty, 1.0 / (total + 1e-16), 0.0)))


class TestTripletAttentionPlain:
    @pytest.mark.parametrize("heads,channels", [(1, 8), (3, 16), (3, 60),
                                                (5, 54), (8, 64)])
    def test_matches_reference(self, heads, channels):
        """Random graphs, 16 empty rows and a receiver of in-degree 300, up
        to H*C = 270 and 512."""
        rng = np.random.RandomState(1)
        snd, rcv, N = _random_batch(rng)
        assert np.bincount(rcv).max() >= 300
        p = _params(rng, N, len(snd), heads, channels)
        want = np.asarray(triplet_attention_reference(
            *[jnp.asarray(v) for v in p.values()], jnp.asarray(snd),
            jnp.asarray(rcv), heads, channels))
        got, row_max, row_inv = _plain(p, snd, rcv, N, heads, channels)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        want_max, want_inv = _jax_stats(p, snd, rcv, N, heads)
        np.testing.assert_allclose(row_max, want_max, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(row_inv, want_inv, rtol=1e-5, atol=1e-7)
        for a in (got, row_max, row_inv):   # empty rows are exactly 0
            assert (a[-16:] == 0).all()

    @pytest.mark.parametrize("heads,channels", [(1, 8), (3, 16)])
    def test_matches_pallas_interpret(self, heads, channels):
        rng = np.random.RandomState(2)
        # the Pallas packing takes at most 256 edges a row
        snd, rcv, N = _random_batch(rng, hub_degree=200)
        p = _params(rng, N, len(snd), heads, channels)
        pk = pack_blocks2(snd, rcv, N)
        packed = [jnp.asarray(v) for v in
                  (pk.perm, pk.local_rcv, pk.local_snd, pk.win_start,
                   pk.edge_mask)]
        want = np.asarray(fused_triplet_attention(
            heads, channels, 0.2, True,
            *[jnp.asarray(v) for v in p.values()], jnp.asarray(snd),
            jnp.asarray(rcv), *packed))
        got = _plain(p, snd, rcv, N, heads, channels)[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_no_edges(self):
        rng = np.random.RandomState(3)
        N, H, C = 5, 3, 8
        p = _params(rng, N, 2, H, C)
        empty = np.zeros(0, np.int32)
        got, row_max, row_inv = _plain(p, empty, empty, N, H, C)
        assert got.shape == (N, H * C) and (got == 0).all()
        assert row_max.shape == row_inv.shape == (N, H)
        assert (row_max == 0).all() and (row_inv == 0).all()

    def test_wrapper_dispatch(self):
        rng = np.random.RandomState(4)
        snd, rcv, N = _random_batch(rng, n_graphs=3, hub_degree=0)
        H, C = 3, 8
        p = {k: torch.from_numpy(v)
             for k, v in _params(rng, N, len(snd), H, C).items()}
        csr = [torch.from_numpy(a) for a in receiver_csr(snd, rcv, N)]
        before = triplet_attention.launches
        got = triplet_attention(*p.values(), *csr, H, C)
        want = triplet_attention_plain(*p.values(), *csr, H, C)[0]
        assert torch.equal(got, want)
        # the CPU path is the plain version: no kernel launch counted
        assert triplet_attention.launches == before
        meta = {k: v.to("meta") for k, v in p.items()}
        with pytest.raises(ValueError, match="cpu or cuda"):
            triplet_attention(*meta.values(), *csr, H, C)


class TestSegmentOps:
    def test_sum_and_softmax(self):
        rng = np.random.RandomState(5)
        ids = np.sort(rng.randint(0, 40, 300)).astype(np.int64)
        ids[ids == 7] = 8                      # an empty segment
        x = rng.randn(300, 3).astype(np.float32) * 5
        for fn in ("segment_sum", "segment_softmax", "segment_mean"):
            want = np.asarray(getattr(jax_segment, fn)(
                jnp.asarray(x), jnp.asarray(ids.astype(np.int32)), 45))
            got = getattr(port_segment, fn)(
                torch.from_numpy(x), torch.from_numpy(ids), 45).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=fn)
        np.testing.assert_array_equal(
            port_segment.segment_count(torch.from_numpy(ids), 45).numpy(),
            np.asarray(jax_segment.segment_count(
                jnp.asarray(ids.astype(np.int32)), 45)))

    def test_dense_and_topk(self):
        """scatter_nodes_to_dense drops pos >= max_nodes; sort-pool ranks
        by the LAST channel, and empty slots (key -inf) come out zero."""
        rng = np.random.RandomState(6)
        sizes = [5, 2, 9, 1]                  # graph 3 has < k nodes
        node_graph = np.concatenate(
            [np.full(n, g) for g, n in enumerate(sizes)]
            + [np.full(20, len(sizes))]).astype(np.int64)
        node_pos = np.concatenate([np.arange(n) for n in sizes]
                                  + [np.arange(20)]).astype(np.int64)
        x = rng.randn(len(node_graph), 6).astype(np.float32)
        G, M = len(sizes) + 1, 8              # graph 2 (9 nodes) overflows
        jx = [jnp.asarray(a) for a in (x, node_graph.astype(np.int32),
                                        node_pos.astype(np.int32))]
        tx = [torch.from_numpy(a) for a in (x, node_graph, node_pos)]
        want = np.asarray(jax_segment.scatter_nodes_to_dense(*jx, G, M))
        got = port_segment.scatter_nodes_to_dense(*tx, G, M).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[2, :8] == x[sum(sizes[:2]):sum(sizes[:2]) + 8]).all()
        want = np.asarray(jax_segment.segment_topk_by_channel(
            jx[0], jx[1], jx[2], G, M, 3))
        got = port_segment.segment_topk_by_channel(*tx, G, M, 3).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[3, 6:] == 0).all()        # 1-node graph: 2 zero rows


@pytest.mark.parametrize("shape, dtype", [
    ((60,), torch.float32), ((60, 5), torch.float32),
    ((60, 5), torch.bfloat16), ((0, 3), torch.float32),
    ((3000, 4), torch.float32)])
def test_segment_sum_in_order_matches_index_add(shape, dtype):
    """``segment_sum`` (each segment summed in CSR order by the CSR-sum
    op, here its plain version; for ids that ascend, over row pointers
    alone, without a permutation) against ``index_add_``, here on the
    CPU: equal in float32 up to summation order (1e-5: sums of up to ~300
    unit-variance terms), empty segments 0; a bfloat16 input is summed in
    float32 and rounded once (1e-2)."""
    from glam_tpu_torch.ops.segment import Segments, segment_sum
    g = torch.Generator().manual_seed(3)
    data = torch.randn(shape, generator=g)
    ids = torch.randint(0, 11, (shape[0],), generator=g)
    ids[ids == 4] = 7                                  # segment 4 empty
    want = torch.zeros((14,) + shape[1:]).index_add_(0, ids, data)
    got = segment_sum(data.to(dtype), ids, 14)
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert (got[4] == 0).all() and (got[11:] == 0).all()
    # sorted ids (node rows grouped by graph): row pointers, no permutation
    ids, order = torch.sort(ids, stable=True)
    rowptr = torch.zeros(15, dtype=torch.int32)
    rowptr[1:] = torch.cumsum(torch.bincount(ids, minlength=14), 0)
    got = Segments(ids, rowptr).sum(data[order].to(dtype))
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
