"""The CSR sum's limit and kernel B's sums that end at the real edges, on
the CPU.

* ``segment_sum_csr_plain`` (and the op's CPU route) with a ``limit``
  bitwise equal to the same sum over the row pointers clamped to it, in
  float32, bfloat16 and float16, with and without a permutation; no slot
  at or past the limit is read;
* the sender CSRs that kernel B's sums run over list the padded edges
  last, the contract those sums rely on: every slot past E_real =
  ``csr_rowptr[-1]`` holds a padded edge (the flagship's parity batch, a
  demo batch at the serving budgets, the DDI pair batch's two towers, a
  random batch with a hub, and ``sender_csr_of`` of each one's budget
  CSR; the sharded tower's [local ; halo] table, a2a and ring), and
  ``sender_csr_of`` lists them last whichever node they name;
* the backward's sums, which end at the real edges, make the padding
  invisible: kernel B's plain backward and the differentiable op's
  gradients over a padded batch equal, bitwise, those over its real
  edges alone, and the sum over the sharded table's sender CSR is the
  same with and without the limit.

The flagship's and the DDI model's outputs and gradients against
``jax.vjp``, whose backward sums end at the real edges, stay in
tests/test_torch_port_reproducible.py at their tolerances.
"""
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from glam_tpu_torch.data.graph import GraphArrays, pad_graphs
from glam_tpu_torch.ops.kernels.segment_sum_csr import (
    segment_sum_csr, segment_sum_csr_plain)
from glam_tpu_torch.ops.kernels.triplet_fused import (
    sender_csr_of, triplet_attention, triplet_attention_bwd,
    triplet_attention_fwd)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------- the plain sum
def _segments(rng, C, dtype, perm):
    """Rows of 0-40 entries, empty rows at both ends, rows of 33, 64, 65
    and 300 entries: x [n + 5, C] and (rowptr, perm) over its first n
    rows."""
    lens = np.concatenate([np.zeros(3, int), rng.randint(0, 41, 60),
                           [33, 64, 65, 300], rng.randint(0, 9, 20),
                           np.zeros(4, int)])
    rowptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(rowptr[-1])
    x = torch.from_numpy(rng.randn(n + 5, C).astype(np.float32)).to(dtype)
    p = (torch.from_numpy(rng.permutation(n + 5)[:n].astype(np.int32))
         if perm else None)
    return x, torch.from_numpy(rowptr), p


LIMITS = {"zero": lambda n: 0, "below": lambda n: n // 3,
          "inside_a_long_row": lambda n: n - 50, "at": lambda n: n,
          "above": lambda n: n + 7}


@pytest.mark.parametrize("perm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("where", list(LIMITS))
def test_plain_limit_equals_clamped_rowptr(where, dtype, perm):
    rng = np.random.RandomState(5)
    x, rowptr, p = _segments(rng, 7, dtype, perm)
    lim = LIMITS[where](int(rowptr[-1]))
    limit = torch.tensor([lim], dtype=torch.int32)
    want = segment_sum_csr_plain(x, rowptr.clamp(max=lim), p)
    got = segment_sum_csr_plain(x, rowptr, p, limit=limit)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(segment_sum_csr(x, rowptr, p, limit), want)


def test_plain_limit_reads_no_slot_past_it():
    """Rows that only the slots past the limit list are NaN: the sum stays
    finite, and the rows cut by the limit are zero."""
    rng = np.random.RandomState(6)
    x, rowptr, p = _segments(rng, 5, torch.float32, True)
    lim = int(rowptr[-1]) // 2
    x[p[lim:].long()] = float("nan")
    got = segment_sum_csr(x, rowptr, p, torch.tensor([lim],
                                                     dtype=torch.int32))
    assert torch.isfinite(got).all()
    cut = rowptr[:-1] >= lim
    assert (got[cut] == 0).all()


# ----------------------------------------- the sender CSRs' padded edges
def _demo_smiles(n):
    with open(ROOT / "datasets" / "demo" / "raw" / "demo.csv",
              newline="") as f:
        return [row["smiles"] for row in csv.DictReader(f)][:n]


def _graphs_of(smiles):
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    out = []
    for s in smiles:
        try:
            x, snd, rcv, e = smiles_to_arrays(s)
        except ValueError:
            continue
        out.append(GraphArrays(x, e, snd, rcv, np.zeros(1, np.float32)))
    return out


def _random_batch():
    """Random graphs, the first with a receiver of in-degree 200, padded
    past them (padding nodes, edges and an empty graph slot)."""
    rng = np.random.RandomState(3)
    gs = []
    for gi in range(7):
        n = rng.randint(3, 14)
        e = rng.randint(2, 3 * n)
        snd = rng.randint(0, n, e)
        rcv = rng.randint(0, n, e)
        if gi == 0:
            snd = np.concatenate([snd, rng.randint(0, n, 200)])
            rcv = np.concatenate([rcv, np.ones(200, int)])
        gs.append(GraphArrays(rng.randn(n, 5).astype(np.float32),
                              rng.randn(len(snd), 4).astype(np.float32),
                              snd.astype(np.int32), rcv.astype(np.int32),
                              np.zeros(1, np.float32)))
    n = sum(g.nodes.shape[0] for g in gs)
    e = sum(g.senders.shape[0] for g in gs)
    return pad_graphs(gs, len(gs) + 1, n + 9, e + 7)


def _batch(case):
    from glam_tpu_torch.data.batching import GraphLoader, PairGraphLoader
    from glam_tpu_torch.serve import pinned_budgets
    if case == "flagship":
        from conftest import SMILES_SET
        gs = _graphs_of(SMILES_SET)
        return next(iter(GraphLoader(gs, batch_size=len(gs), num_tasks=1)))
    if case == "demo_serving":
        gs = _graphs_of(_demo_smiles(140))[:128]
        nb, eb = pinned_budgets(128, 132)
        return next(iter(GraphLoader(gs, 128, 1, node_budget=nb,
                                     edge_budget=eb)))
    if case.startswith("ddi"):
        with open(ROOT / "datasets" / "ddi_demo" / "raw" /
                  "drugbank_caster.csv", newline="") as f:
            rows = list(csv.DictReader(f))[::37][:12]
        a = _graphs_of(r["Drug1_SMILES"] for r in rows)
        b = _graphs_of(r["Drug2_SMILES"] for r in rows)
        pair = next(iter(PairGraphLoader(list(zip(a, b)), 12, 1)))
        return pair[int(case[-1]) - 1]
    return _random_batch()


BATCHES = ["flagship", "demo_serving", "ddi_1", "ddi_2", "random_hub"]


def _padded_last(rowptr, eid, e_real, pads):
    """Whether the sender CSR (rowptr, eid) lists exactly ``pads`` past
    slot ``e_real``, and every other edge before it."""
    eid = eid.numpy()
    return (int(rowptr[-1]) == eid.shape[0]
            and sorted(eid[e_real:].tolist()) == sorted(pads)
            and sorted(eid[:e_real].tolist()) == sorted(
                set(range(eid.shape[0])) - set(pads)))


@pytest.mark.parametrize("case", BATCHES)
def test_sender_csr_lists_the_padded_edges_last(case):
    b = _batch(case)
    e_real = int(b.csr_rowptr[-1])
    pads = list(range(e_real, b.num_edges))
    assert b.num_edges > e_real, "a batch padded past its edges"
    assert _padded_last(b.snd_rowptr, b.snd_eid, e_real, pads)
    # the one the backward builds where a caller gives none: of the
    # receiver CSR padded to the edge budget (``budget_csr``)
    built = sender_csr_of(b.csr_snd, b.csr_eid, b.num_nodes, b.csr_rowptr)
    assert _padded_last(*built, e_real, pads)


@pytest.mark.parametrize("sender", ["first", "middle", "random"])
def test_sender_csr_of_lists_padded_slots_last_whoever_sends_them(sender):
    """A receiver CSR whose padded slots name other senders than the last
    node: ``sender_csr_of`` with its row pointers still lists them last,
    and the real edges' rows as without them."""
    b = _random_batch()
    N, E = b.num_nodes, b.num_edges
    e_real = int(b.csr_rowptr[-1])
    rng = np.random.RandomState(9)
    who = {"first": np.zeros(E - e_real, int),
           "middle": np.full(E - e_real, N // 2),
           "random": rng.randint(0, N, E - e_real)}[sender]
    csr_snd = b.csr_snd.clone()
    csr_snd[e_real:] = torch.from_numpy(who.astype(np.int32))
    rowptr, eid = sender_csr_of(csr_snd, b.csr_eid, N, b.csr_rowptr)
    assert _padded_last(rowptr, eid, e_real, list(range(e_real, E)))
    real = sender_csr_of(csr_snd[:e_real], b.csr_eid[:e_real], N,
                         b.csr_rowptr)
    assert torch.equal(rowptr.clamp(max=e_real), real[0])
    assert torch.equal(eid[:e_real], real[1])


def _shard(halo):
    """Rank 0's shard of two graphs packed together at the budgets of a
    corpus that also holds a larger one, so that its slots are padded."""
    from test_torch_port_sharded import giant_graph
    from glam_tpu_torch.parallel import sharded_model as sm
    gs = [GraphArrays(*giant_graph(seed=s, N=n, E=e),
                      np.zeros(1, np.float32))
          for s, n, e in ((4, 120, 360), (5, 90, 200), (6, 70, 150))]
    budgets = sm.corpus_budgets(gs, 2, halo)
    return sm.pack_shards([sm.shard_at(g, 2, 0, budgets) for g in gs[1:]],
                          2)


@pytest.mark.parametrize("halo", ["a2a", "ring"])
def test_sharded_table_sender_csr_lists_the_padded_edges_last(halo):
    """The sharded tower's [local ; halo] table: its receiver CSR's pads
    are sent by the last table row, so ``sender_csr_of`` lists them last,
    and the sum of d_xp's terms over it is the same with the limit."""
    s = _shard(halo)
    T, E = s.table_rows, s.csr_snd.shape[0]
    e_real = int(s.csr_rowptr[-1])
    assert E > e_real
    rowptr, eid = sender_csr_of(s.csr_snd, s.csr_eid, T, s.csr_rowptr)
    assert _padded_last(rowptr, eid, e_real, list(range(e_real, E)))
    rng = np.random.RandomState(7)
    terms = torch.from_numpy(rng.randn(E, 12).astype(np.float32))
    terms[e_real:] = 0.0                # kernel B's zeros for the pads
    want = segment_sum_csr_plain(terms, rowptr, eid)
    got = segment_sum_csr_plain(terms, rowptr, eid,
                                limit=s.csr_rowptr[T:])
    assert torch.equal(got, want)


# ------------------------------ kernel B over the padding and without
def _inputs(b, H, C, seed):
    rng = np.random.RandomState(seed)
    N = b.num_nodes
    w_e = rng.randn(H, C)
    wemat = np.zeros((H * C, H))
    for h in range(H):
        wemat[h * C:(h + 1) * C, h] = w_e[h]
    host = [rng.randn(N, H * C), rng.randn(N, H), rng.randn(N, H),
            b.edges.numpy().astype(np.float64),
            rng.randn(b.edges.shape[1], H * C) * 0.3, wemat]
    g = rng.randn(N, H * C).astype(np.float32)
    return [torch.from_numpy(a.astype(np.float32)) for a in host], \
        torch.from_numpy(g)


@pytest.mark.parametrize("case", BATCHES)
def test_bwd_plain_with_the_limit_is_bitwise(case):
    """``triplet_attention_bwd`` (its plain version on the CPU) over the
    padded batch, its sums ending at the real edges, against the same
    backward over the batch's real edges alone (the slots, edge rows and
    sender CSR cut at E_real): d_xp, d_a_i and the real edges' rows of
    d_eh and d_pre bitwise equal, the padded edges' rows zero; the
    differentiable op's gradients of xp, a_i and a_j (d_a_j summed with
    the limit) bitwise equal too, and those of the edge weights within
    1e-4 of their largest entry: their products sum over E or E_real
    rows, which the matrix product may block in other orders (float32
    rounding, ~1e-5 relative at the serving budget's 16,904 rows)."""
    b = _batch(case)
    H, C = 3, 12
    e_real = int(b.csr_rowptr[-1])
    leaves, g = _inputs(b, H, C, 11)
    csr = (b.csr_rowptr, b.csr_snd, b.csr_eid)
    snd = (b.snd_rowptr, b.snd_eid)
    cut = leaves[:3] + [leaves[3][:e_real]] + leaves[4:]
    csr_cut = (b.csr_rowptr, b.csr_snd[:e_real], b.csr_eid[:e_real])
    snd_cut = (b.snd_rowptr.clamp(max=e_real), b.snd_eid[:e_real])
    stats = triplet_attention_fwd(*leaves, *csr, H, C)
    stats_cut = triplet_attention_fwd(*cut, *csr_cut, H, C)
    for x, y in zip(stats, stats_cut):
        assert torch.equal(x, y)
    padded = triplet_attention_bwd(*leaves, *csr, *stats, g, H, C, 0.2,
                                   *snd)
    alone = triplet_attention_bwd(*cut, *csr_cut, *stats_cut, g, H, C,
                                  0.2, *snd_cut)
    for name, x, y in zip(("d_xp", "d_eh", "d_pre", "d_a_i"), padded,
                          alone):
        if name in ("d_eh", "d_pre"):
            assert (x[e_real:] == 0).all(), name
            x = x[:e_real]
        assert torch.equal(x, y), name

    def grads(inputs, rows, senders):
        ls = [t.clone().requires_grad_(True) for t in inputs]
        triplet_attention(*ls, *rows, H, C, 0.2, *senders).backward(g)
        return [t.grad for t in ls]

    full, real = grads(leaves, csr, snd), grads(cut, csr_cut, snd_cut)
    for x, y in zip(full[:3], real[:3]):
        assert torch.equal(x, y)
    assert (full[3][e_real:] == 0).all()
    assert torch.equal(full[3][:e_real], real[3])
    for x, y in zip(full[4:], real[4:]):
        torch.testing.assert_close(x, y, rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()))
