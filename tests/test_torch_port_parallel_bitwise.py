"""The parallel paths' fixed-order sums: the node-sharded tower's gathers
summed by the CSR sum in slot order, and every SUM all-reduce a sum in
rank order (``glam_tpu_torch/parallel/``), on the CPU.

  * ``pack_shards``' three new CSRs (every edge slot by sender over the
    [local ; halo] table, by receiver over the local rows, and the halo
    sends' rows over the local rows; a2a and ring, one and two pairs a
    step): each slot listed once, in the row its id names, a row's slots
    ascending, against a loop;
  * the backward of those gathers against ``jax.vjp`` of ``x[ids]``, as
    ``tests/test_torch_port_reproducible.py`` holds the batch's (1e-6);
  * one spawn of 4 gloo ranks (``tests/torch_port_dp_worker.py``, tasks
    ``rank_sum`` and ``sharded_autograd``):
      - the autograd graph of the sharded tower's loss, for each of the
        5 convs, a2a and ring over 4 shards, holds no ``index_select``,
        ``index_add_`` or ``scatter_add`` node (whose backward or
        forward adds with atomics on the card), and its CSR sums are
        ``chip_smoke.sharded_csr_sums``' count;
      - ``distributed.all_reduce_sum`` over 2, 3 and 4 ranks equals the
        left-to-right sum of the ranks' terms computed here, bitwise, on
        every rank; at 2 ranks also ``torch.distributed.all_reduce``'s.

On the card (marked ``cuda``; it skips here), the 1,000-residue protein's
sharded forward and backward twice over 2 gloo ranks, bitwise:

    python -m pytest --noconftest tests/test_torch_port_parallel_bitwise.py \\
        -m cuda -q
"""
import json

import numpy as np
import pytest
import torch

from glam_tpu_torch.data.graph import GraphArrays
from glam_tpu_torch.parallel import sharded_model as sm
from torch_port_dp_worker import rank_terms, spawn_ranks, wait_ranks

D = 2
RANKS = 4
CONVS = {"_TripletMessage": "Set2Set", "_TripletMessageLight": "GlobalLAPool",
         "_GATConv": "GlobalPool5", "_NNConv": "GlobalLAPool",
         "_GCNConv": "Set2Set"}
ATOMIC = {"IndexSelectBackward0", "IndexAddBackward0", "ScatterAddBackward0"}


def _proteins():
    from test_torch_port_partition import contact_graph
    return [GraphArrays(*contact_graph(L=120, seed=s),
                        y=np.zeros(1, np.float32)) for s in (0, 5)]


def _shards(halo, B):
    """Both ranks' packed shards of B proteins at their corpus budgets."""
    graphs = _proteins()[:B]
    budgets = sm.corpus_budgets(graphs, D, halo)
    return [sm.pack_shards([sm.shard_at(g, D, r, budgets) for g in graphs],
                           D) for r in range(D)]


def _segments(shard, kind):
    """(the Segments of one kind, its row count) of a shard; the sends'
    as a list."""
    R = shard.n_pairs * shard.n_local
    if kind == "sender":
        return [shard.sender_segments], shard.table_rows
    if kind == "receiver":
        return [shard.receiver_segments], R
    return shard.send_segments(), R


@pytest.mark.parametrize("kind", ["sender", "receiver", "send"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("halo", ["a2a", "ring"])
def test_pack_shards_segments_list_each_slot_once_in_order(halo, B, kind):
    for shard in _shards(halo, B):
        segs, rows = _segments(shard, kind)
        if kind == "send":
            assert len(segs) == (1 if halo == "a2a" else D - 1)
        for seg in segs:
            ids = seg.ids.numpy()
            want = [[] for _ in range(rows)]
            for slot, row in enumerate(ids):
                want[row].append(slot)
            lengths = [len(w) for w in want]
            assert seg.rowptr.dtype == torch.int32
            assert seg.perm.dtype == torch.int32
            np.testing.assert_array_equal(
                seg.rowptr.numpy(), np.concatenate([[0], np.cumsum(lengths)]))
            np.testing.assert_array_equal(
                seg.perm.numpy(), np.concatenate([np.asarray(w, np.int64)
                                                  for w in want]))


@pytest.mark.parametrize("kind", ["sender", "receiver", "send_a2a",
                                  "send_ring"])
def test_shard_gathers_backward_matches_jax_vjp(kind):
    import jax
    halo = "ring" if kind == "send_ring" else "a2a"
    shard = _shards(halo, 2)[0]
    rng = np.random.RandomState(3)
    for seg in _segments(shard, kind.split("_")[0])[0]:
        S = seg.rowptr.shape[0] - 1
        x = rng.randn(S, 7).astype(np.float32)
        ct = rng.randn(seg.ids.shape[0], 7).astype(np.float32)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = seg.gather(xt)
        assert torch.equal(out, xt.detach()[seg.ids])
        out.backward(torch.from_numpy(ct))
        ids = jax.numpy.asarray(seg.ids.numpy())
        _, vjp = jax.vjp(lambda a: a[ids], jax.numpy.asarray(x))
        want = np.asarray(vjp(jax.numpy.asarray(ct))[0])
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def _cases():
    """One single-graph case a conv (its readout from CONVS, LayerNorm
    for the statistics' all-reduces), weights from a seed."""
    from glam_tpu_torch.nn import model as port_model
    from test_torch_port_partition import contact_graph
    graph = contact_graph(L=120, seed=0, fn=15, fe=4)
    cases = {}
    for conv, readout in CONVS.items():
        cfg = dict(mol_block=conv, mol_readout=readout, message_steps=2,
                   e_dim=32, hid_dim_alpha=2, max_nodes=128,
                   graph_norm="_LayerNorm", pre_do="_None()",
                   graph_do="_None()", flat_do="_None()", end_do="_None()",
                   pre_act="CELU", graph_act="CELU", flat_act="CELU",
                   end_act="CELU")
        model = port_model.Architecture(port_model.ModelConfig(**cfg),
                                        torch.Generator().manual_seed(2))
        cases[conv] = dict(kind="single", cfg=cfg, graphs=[graph],
                           state=model.state_dict())
    return cases


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Rank 0's results of the rank-sum and autograd tasks over 4 gloo
    ranks."""
    work = tmp_path_factory.mktemp("parallel_bitwise")
    torch.save(_cases(), work / "sharded.pt")
    (work / "plan.json").write_text(json.dumps(
        {"tasks": ["rank_sum", "sharded_autograd"]}))
    return wait_ranks(spawn_ranks(work, "cpu", RANKS), work, timeout=600)


@pytest.mark.parametrize("halo", ["a2a", "ring"])
@pytest.mark.parametrize("conv", list(CONVS))
def test_sharded_tower_backward_has_no_atomic_node(four_ranks, conv, halo):
    from chip_smoke import sharded_csr_sums
    got = four_ranks["sharded_autograd"][f"{conv}_{halo}"]
    nodes = set(got["nodes"])
    assert not nodes & ATOMIC, sorted(nodes & ATOMIC)
    assert "_GatherRowsBackward" in nodes
    assert got["sends"] == (1 if halo == "a2a" else RANKS - 1)
    assert tuple(got["csr"]) == sharded_csr_sums(conv, 2, got["sends"])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_rank_ordered_sum_is_left_to_right_on_every_rank(four_ranks, n):
    terms = [rank_terms(r) for r in range(n)]
    want = terms[0]
    for t in terms[1:]:
        want = want + t
    by_rank = four_ranks["rank_sum"][n]
    assert by_rank[n:] == [None] * (RANKS - n)
    for r in range(n):
        assert torch.equal(by_rank[r]["sum"], want), r
        if n == 2:
            assert torch.equal(by_rank[r]["all_reduce"], want), r
    if n > 2:
        # the terms' magnitudes make the order show in the bits
        back = terms[-1]
        for t in terms[-2::-1]:
            back = back + t
        assert not torch.equal(back, want)


@pytest.mark.cuda
def test_sharded_protein_backward_twice_is_bitwise(tmp_path):
    """The 1,000-residue protein at full width (``chip_smoke.
    sharded_protein_cases``: GAT and TripletMessage protein towers) over
    2 gloo ranks sharing cuda:0: the sharded pair forward and its loss's
    backward twice from one state, eagerly; outputs and every gradient
    bitwise equal on rank 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import sharded_protein_cases
    torch.save(sharded_protein_cases(time=False), tmp_path / "sharded.pt")
    (tmp_path / "plan.json").write_text('{"tasks": ["sharded_twice"]}')
    got = wait_ranks(spawn_ranks(tmp_path, "cuda"), tmp_path,
                     timeout=600)["sharded_twice"]
    for name, (a, b) in got.items():
        assert torch.equal(a["out"], b["out"]), name
        for k in a["grads"]:
            assert torch.equal(a["grads"][k], b["grads"][k]), (name, k)
