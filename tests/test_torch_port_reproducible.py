"""Fixed-order sums: the CSR-sum op and the CSRs a batch carries for it,
against the JAX package on the CPU; on the card, the kernel against its
plain version and a training run that repeats itself bit for bit.

On the CPU (JAX imported inside the tests, so that a machine without
JAX can run the ``cuda`` ones):
  * ``segment_sum_csr``'s plain version against
    ``glam_tpu.ops.segment.segment_sum`` over node rows by graph, edge
    slots by receiver (padded slots included) and by sender, empty
    segments, and bfloat16 rows summed in float32 (rtol 1e-6; bfloat16:
    one rounding, 2**-8);
  * ``sender_csr`` against a loop over the edges, exactly;
  * ``gather_rows``' backward against ``jax.vjp`` of the gather (1e-6);
  * kernel B's plain version with d_xp and d_a_j summed over the batch's
    sender CSR against ``jax.vjp`` of the Pallas kernel in interpret mode
    (atol 1e-5 + rtol 1e-5, as tests/test_torch_port_backward.py);
  * the flagship's and the DDI model's outputs (1e-4) and whole gradient
    trees (rtol 5e-4) against the JAX package with converted weights.

On the card (marked ``cuda``; they skip here):

    python -m pytest --noconftest tests/test_torch_port_reproducible.py \\
        -m cuda -q
"""
import numpy as np
import pytest
import torch

from glam_tpu_torch.data.graph import GraphArrays, pad_graphs, sender_csr
from glam_tpu_torch.ops.kernels.segment_sum_csr import (
    gather_rows, segment_sum_csr, segment_sum_csr_plain)
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_bwd, triplet_attention_fwd)

NAMES = ("xp", "a_i", "a_j", "edge_attr", "we", "wemat")


def _graphs(rng, n_graphs=6, fe=4, hub=0):
    """Random molecules-like graphs (the first with a receiver of in-degree
    ``hub`` when given)."""
    out = []
    for gi in range(n_graphs):
        n = rng.randint(3, 14)
        e = rng.randint(2, 3 * n)
        snd = rng.randint(0, n, e).astype(np.int32)
        rcv = rng.randint(0, n, e).astype(np.int32)
        if gi == 0 and hub:
            snd = np.concatenate([snd, rng.randint(0, n, hub)]).astype(
                np.int32)
            rcv = np.concatenate([rcv, np.ones(hub, np.int32)])
        out.append(GraphArrays(
            rng.randn(n, 5).astype(np.float32),
            rng.randn(len(snd), fe).astype(np.float32), snd, rcv,
            np.zeros(1, np.float32)))
    return out


def _batch(seed=0, hub=0):
    """A batch padded past its graphs: padding nodes and edges, and an
    empty graph slot."""
    rng = np.random.RandomState(seed)
    gs = _graphs(rng, hub=hub)
    n = sum(g.nodes.shape[0] for g in gs)
    e = sum(g.senders.shape[0] for g in gs)
    return pad_graphs(gs, len(gs) + 1, n + 9, e + 7)


def _jax():
    return pytest.importorskip("jax")


# ------------------------------------------------------ the CSR-sum op
def _csr_case(case):
    """(x, ids, rowptr, perm, S) of one case."""
    b = _batch(1)
    rng = np.random.RandomState(2)
    if case == "graphs":
        seg = b.by_graph
    elif case == "receivers_padded":
        seg = b.by_receiver
    elif case == "senders":
        seg = b.by_sender
    else:                                   # empty segments, bf16 rows
        ids = np.sort(rng.randint(0, 40, 300))
        ids[(ids == 7) | (ids == 8)] = 9
        rowptr = np.searchsorted(ids, np.arange(46)).astype(np.int32)
        seg = (torch.from_numpy(ids), torch.from_numpy(rowptr), None)
    ids, rowptr, perm = seg[0], seg[1], seg[2]
    C = 60 if case != "graphs" else 1
    x = torch.from_numpy(rng.randn(ids.shape[0], C).astype(np.float32) * 3)
    if case == "graphs":
        x = x[:, 0]
    return x, ids, rowptr, perm, rowptr.shape[0] - 1


@pytest.mark.parametrize("case", ["graphs", "receivers_padded", "senders",
                                  "empty_segments", "bf16"])
def test_csr_sum_matches_jax_segment_sum(case):
    jax = _jax()
    from glam_tpu.ops import segment as jax_segment
    x, ids, rowptr, perm, S = _csr_case(case)
    if case == "bf16":
        x = x.to(torch.bfloat16)
    got = segment_sum_csr_plain(x, rowptr, perm)
    assert got.dtype == x.dtype and got.shape == (S,) + tuple(x.shape[1:])
    want = np.asarray(jax_segment.segment_sum(
        jax.numpy.asarray(x.float().numpy()),
        jax.numpy.asarray(ids.numpy().astype(np.int32)), S))
    if case == "bf16":
        # summed in float32, rounded once to bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    empty = (rowptr[1:] == rowptr[:-1]).numpy()
    assert (got.float().numpy()[empty] == 0).all()
    # the op the model calls, on the CPU: the plain version, no launch
    before = segment_sum_csr.launches
    assert torch.equal(segment_sum_csr(x, rowptr, perm), got)
    assert segment_sum_csr.launches == before


@pytest.mark.parametrize("seed", [0, 3])
def test_sender_csr_matches_a_loop(seed):
    b = _batch(seed)
    snd = b.senders.numpy()
    N, E = b.num_nodes, b.num_edges
    rowptr, eid = sender_csr(snd, N)
    assert rowptr.dtype == eid.dtype == np.int32
    want_ptr, want_eid = [0], []
    for n in range(N):
        mine = [e for e in range(E) if snd[e] == n]
        want_eid += mine
        want_ptr.append(len(want_eid))
    np.testing.assert_array_equal(rowptr, want_ptr)
    np.testing.assert_array_equal(eid, want_eid)
    np.testing.assert_array_equal(b.snd_rowptr.numpy(), want_ptr)
    np.testing.assert_array_equal(b.snd_eid.numpy(), want_eid)
    # the padded edges end the last node's row, after its real ones
    real = int(b.edge_mask.sum())
    np.testing.assert_array_equal(eid[-(E - real):], np.arange(real, E))
    np.testing.assert_array_equal(
        b.graph_rowptr.numpy(), np.concatenate([[0], np.cumsum(
            b.n_node.numpy())]))


@pytest.mark.parametrize("which", ["by_sender", "by_receiver", "by_graph"])
def test_gather_rows_backward_matches_jax_vjp(which):
    jax = _jax()
    b = _batch(4)
    seg = getattr(b, which)
    rng = np.random.RandomState(5)
    S = seg.rowptr.shape[0] - 1
    x = rng.randn(S, 7).astype(np.float32)
    ct = rng.randn(seg.ids.shape[0], 7).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gather_rows(xt, seg.ids, seg.rowptr, seg.perm)
    assert torch.equal(out, xt.detach()[seg.ids])
    out.backward(torch.from_numpy(ct))
    ids = jax.numpy.asarray(seg.ids.numpy())
    _, vjp = jax.vjp(lambda a: a[ids], jax.numpy.asarray(x))
    want = np.asarray(vjp(jax.numpy.asarray(ct))[0])
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ kernel B
def _triplet_inputs(rng, b, H, C):
    N, E = b.num_nodes, b.num_edges
    w_e = rng.randn(H, C)
    wemat = np.zeros((H * C, H))
    for h in range(H):
        wemat[h * C:(h + 1) * C, h] = w_e[h]
    edge_attr = b.edges.numpy().astype(np.float64)
    host = [rng.randn(N, H * C), rng.randn(N, H), rng.randn(N, H), edge_attr,
            rng.randn(edge_attr.shape[1], H * C) * 0.3, wemat]
    return [a.astype(np.float32) for a in host]


@pytest.mark.parametrize("heads,channels", [(3, 60), (2, 8)])
def test_kernel_b_plain_over_the_sender_csr_matches_pallas(heads, channels):
    """d_xp and d_a_j summed over the batch's sender CSR (every edge slot,
    padded ones included), against ``jax.vjp`` of the Pallas kernel in
    interpret mode over the real edges."""
    jax = _jax()
    from glam_tpu.ops.pallas.triplet_fused import (fused_triplet_attention,
                                                   pack_blocks2)
    jnp = jax.numpy
    H, C = heads, channels
    b = _batch(6)
    rng = np.random.RandomState(8)
    host = _triplet_inputs(rng, b, H, C)
    g = rng.randn(b.num_nodes, H * C).astype(np.float32)
    g[-1] = 0.0                 # the padding node's cotangent, as in a model
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in host]
    csr = (b.csr_rowptr, b.csr_snd, b.csr_eid)
    triplet_attention(*leaves, *csr, H, C, 0.2, b.snd_rowptr,
                      b.snd_eid).backward(torch.from_numpy(g))
    got = dict(zip(NAMES, (a.grad.numpy() for a in leaves)))
    # the sum over the batch's sender CSR and the one made from the
    # receiver CSR add the same terms, each in its own fixed order
    stats = triplet_attention_fwd(*[a.detach() for a in leaves], *csr, H, C)
    d_xp = triplet_attention_bwd(*[a.detach() for a in leaves], *csr, *stats,
                                 torch.from_numpy(g), H, C)[0]
    np.testing.assert_allclose(got["xp"], d_xp.numpy(), rtol=1e-6,
                               atol=1e-6)

    E_real = int(b.csr_rowptr[-1])
    snd = b.senders.numpy()[:E_real].astype(np.int32)
    rcv = b.receivers.numpy()[:E_real].astype(np.int32)
    pk = pack_blocks2(snd, rcv, b.num_nodes)
    packed = [jnp.asarray(v) for v in (pk.perm, pk.local_rcv, pk.local_snd,
                                       pk.win_start, pk.edge_mask)]
    j = [jnp.asarray(a) for a in host]
    j_real = j[:3] + [j[3][:E_real]] + j[4:]

    def fused(*a):
        return fused_triplet_attention(H, C, 0.2, True, *a, jnp.asarray(snd),
                                       jnp.asarray(rcv), *packed)

    _, vjp = jax.vjp(fused, *j_real)
    want = dict(zip(NAMES, (np.asarray(x) for x in vjp(jnp.asarray(g)))))
    got["edge_attr"] = got["edge_attr"][:E_real]
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# ------------------------------------------------------------- models
def test_flagship_output_and_gradients_match_jax(request):
    """The flagship's layout at small widths (TripletMessage H=3, 3
    weight-tied steps, PairNorm, GlobalPool5) without noise: output 1e-4
    and the whole gradient tree rtol 5e-4 (of an entry, or of its
    tensor's largest entry)."""
    jax = _jax()
    from conftest import SMILES_SET
    from glam_tpu.data.batching import GraphLoader as JaxLoader
    from glam_tpu.nn import model as jax_model
    from glam_tpu.train.trainer import make_loss_fn as jax_loss_fn
    from glam_tpu_torch import convert
    from glam_tpu_torch.nn import model as port_model
    from glam_tpu_torch.train.trainer import make_loss_fn as port_loss_fn
    from test_torch_port_model import _cfg, _np_tree, _port_batch
    jb = next(iter(JaxLoader(request.getfixturevalue("sample_graphs"),
                             batch_size=6, num_tasks=1)))
    pb = _port_batch(SMILES_SET)
    kw = dict(graph_norm="_PairNorm", graph_do="_None()", end_do="_None()")
    model_j = jax_model.Architecture(_cfg(jax_model.ModelConfig, **kw))
    params = model_j.init(jax.random.PRNGKey(11), jb, True)["params"]
    loss_j = jax_loss_fn("regression", "mse", 1)

    def objective(p):
        out = model_j.apply({"params": p}, jb, False)
        return loss_j(out, jb.y, jb.graph_mask), out

    (_, out_j), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    cfg_t = _cfg(port_model.ModelConfig, **kw)
    model_t = port_model.Architecture(cfg_t)
    model_t.load_state_dict(convert.state_dict_from_jax(_np_tree(params),
                                                        cfg_t))
    model_t.train()
    out_t = model_t(pb)
    port_loss_fn("regression", "mse", 1)(out_t, pb.y, pb.graph_mask
                                         ).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    grads_j = convert.state_dict_from_jax(_np_tree(grads), cfg_t)
    named = dict(model_t.named_parameters())
    assert set(named) == set(grads_j)
    for name, want in grads_j.items():
        # rtol 5e-4 of the entry or of the tensor's largest: the edge
        # weights' gradient sums over every edge and cancels, and at this
        # seed both packages' float32 values lie ~3e-6 from float64 on
        # entries of 1e-2
        scale = float(want.abs().max())
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                   rtol=5e-4, atol=5e-4 * scale + 1e-6,
                                   err_msg=name)


def test_ddi_output_and_gradients_match_jax():
    """The DDI pair model (two TripletMessage towers with PairNorm and a
    fusion per step) at small widths: output 1e-4, gradient tree rtol
    5e-4."""
    jax = _jax()
    import jax.numpy as jnp
    from test_torch_port_model import _np_tree
    from test_torch_port_pair_model import _models
    from glam_tpu_torch import convert
    model_j, params, model_t, cfg_t, jb, pb = _models("homo",
                                                      "_TripletMessage", 5)
    w = np.random.RandomState(3).randn(jb[0].n_node.shape[0],
                                       cfg_t.out_dim).astype(np.float32)
    mask = np.asarray(jb[0].graph_mask, np.float32)[:, None]

    def objective(p):
        out = model_j.apply({"params": p}, *jb, True)
        return jnp.sum(out * w * mask), out

    (_, out_j), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    model_t.eval()
    out_t = model_t(*pb)
    ((out_t * torch.from_numpy(w * mask)).sum()).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-4)
    grads_j = convert.state_dict_from_jax(_np_tree(grads), cfg_t,
                                          pair="homo")
    named = dict(model_t.named_parameters())
    assert set(named) == set(grads_j)
    for name, want in grads_j.items():
        scale = max(float(want.abs().max()), 1.0)
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                   rtol=5e-4, atol=1e-6 * scale,
                                   err_msg=name)


# ------------------------------------------- the smoke's launch counts
COUNT_CASES = {
    "flagship": (dict(mol_block="_TripletMessage", graph_norm="_PairNorm"),
                 None),
    "library": (dict(mol_block="_TripletMessageLight", mol_readout="Set2Set",
                     graph_norm="_BatchNorm", flat_norm="_BatchNorm",
                     end_norm="_LayerNorm"), None),
    "gat_lapool": (dict(mol_block="_GATConv", mol_readout="GlobalLAPool",
                        pre_norm="_LayerNorm",
                        graph_norm="_GraphSizeNorm"), None),
    "default": (dict(mol_block="_NNConv", graph_norm="_PairNorm"), None),
    "gcn_layernorm": (dict(mol_block="_GCNConv", graph_norm="_LayerNorm"),
                      None),
    "ddi": (dict(mol_block="_TripletMessage", graph_norm="_PairNorm"),
            False),
    "dti_gat": (dict(mol_block="_TripletMessage", pro_block="_GATConv",
                     graph_norm="_PairNorm", out_dim=2), True),
    "screening_gcn": (dict(mol_block="_TripletMessage",
                           pro_block="_GCNConv", pro_readout="GlobalLAPool",
                           out_dim=2), True)}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_smoke_counts_the_csr_sums_of_a_config(case, monkeypatch):
    """``chip_smoke.csr_sums``, the CSR sum's launches the smoke expects
    of a config in a forward and in a training step, against the calls of
    its op counted here on the CPU, where each would be a launch on the
    card (the plain version stands in for the kernel)."""
    from chip_smoke import csr_sums
    from glam_tpu_torch.data.batching import PairGraphLoader
    from glam_tpu_torch.nn import model as port_model
    from glam_tpu_torch.ops.kernels import segment_sum_csr as csr_mod
    from glam_tpu_torch.ops.kernels import triplet_fused
    calls = [0]
    plain = csr_mod.segment_sum_csr_plain

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(csr_mod, "segment_sum_csr_plain", counted)
    monkeypatch.setattr(triplet_fused, "segment_sum_csr_plain", counted)
    kw, hetero = COUNT_CASES[case]
    cfg = port_model.ModelConfig(
        hid_dim_alpha=1, e_dim=8, mol_in_dim=5, mol_edge_in_dim=4,
        pro_in_dim=6, pro_edge_in_dim=3, max_nodes=16, pro_max_nodes=16,
        pre_act="CELU", graph_act="CELU", flat_act="CELU", end_act="CELU",
        graph_do="_None()", end_do="_None()", **kw)
    rng = np.random.RandomState(1)
    if hetero is None:
        model = port_model.Architecture(cfg)
        parts = (_batch(2),)
    else:
        model = port_model.PairArchitecture(cfg, hetero=hetero)
        mols = _graphs(rng, 4)
        others = _graphs(rng, 4, fe=3)
        if hetero:
            others = [g._replace(nodes=rng.randn(g.nodes.shape[0], 6)
                                 .astype(np.float32)) for g in others]
        else:
            others = _graphs(rng, 4)
        parts = next(iter(PairGraphLoader(list(zip(mols, others)), 4, 1)))
    model.eval()
    with torch.no_grad():
        model(*parts)
    fwd = calls[0]
    model.train()
    calls[0] = 0
    model(*parts).sum().backward()
    assert (fwd, calls[0] - fwd) == csr_sums(cfg, hetero=hetero)


# ----------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_segments(rng, lens, C, dtype, perm=True):
    """x [sum(lens) + 5, C] and a CSR of segments of ``lens`` entries over
    a permutation of its first sum(lens) rows (the last 5 listed by no
    slot), on the CPU."""
    rowptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(rowptr[-1])
    x = torch.from_numpy(rng.randn(n + 5, C).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.permutation(n + 5)[:n].astype(np.int32)) \
        if perm else None
    return x, torch.from_numpy(rowptr), p


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 60, 180, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_csr_sum_kernel_matches_plain_and_repeats(cuda, C, dtype):
    """Empty segments at both ends, segments of 0-40 entries, empty runs,
    one of 5,000 and one of 33; of 64 and 65 (a row warp's most and a
    cluster's least), of the cluster's span less one, the span and one
    more, runs of 60-130, one that straddles two clusters' windows and
    the serving batch's 44,096: the kernel against its plain version in
    float64 within ``chip_smoke.csr_sum_tol`` (1e-6 of the segment's sum
    of magnitudes; bfloat16 and float16: and 2**-8 of the result, its one
    rounding), two calls bitwise equal, one launch each, each merging at
    the global level (counted on the device) the segments longer than the
    span and no other; without a permutation too, and with a limit below,
    at and above rowptr[-1]."""
    from chip_smoke import csr_sum_tol
    from glam_tpu_torch.ops.kernels.segment_sum_csr import (
        constants, ticket_merges)
    span = constants()["span"]
    rng = np.random.RandomState(C)
    head = np.concatenate([np.zeros(3, int), rng.randint(0, 41, 300),
                           np.zeros(40, int), [5000], rng.randint(0, 9, 50),
                           [33, 64, 65, span - 1, span, span + 1],
                           rng.randint(60, 131, 30)])
    # the next segment starts 100 slots before a window's end
    fill = -int(head.sum() + 100) % span
    lens = np.concatenate([head, [fill + span if fill < 70 else fill, 300],
                           [44096], rng.randint(0, 41, 20),
                           np.zeros(5, int)])
    for perm in (True, False):
        x, rowptr, p = _random_segments(rng, lens, C, dtype, perm)
        n = int(rowptr[-1])
        for lim in (None, n - 20000, n, n + 3):      # below: in the 44,096
            rows = rowptr if lim is None else rowptr.clamp(max=lim)
            want, tol = csr_sum_tol(x, rows, p, int(rows[-1]))
            xd, rd = x.to(cuda), rowptr.to(cuda)
            pd = p.to(cuda) if p is not None else None
            ld = (torch.tensor([lim], dtype=torch.int32, device=cuda)
                  if lim is not None else None)
            before = segment_sum_csr.launches
            ticket_merges(cuda)
            got = segment_sum_csr(xd, rd, pd, ld)
            again = segment_sum_csr(xd, rd, pd, ld)
            assert segment_sum_csr.launches == before + 2
            past = int(((rows[1:] - rows[:-1]) > span).sum())
            assert ticket_merges(cuda) == 2 * past, (perm, lim)
            assert torch.equal(got, again), (perm, lim)
            assert ((got.cpu().double() - want).abs() <= tol).all(), \
                (perm, lim)


@pytest.mark.cuda
def test_kernel_b_d_xp_is_bitwise_across_calls(cuda):
    """Kernel B at a padded batch's CSR with a hub row: d_xp (each edge's
    term summed over the sender CSR) and d_a_j the same on every call,
    and the batch's sender CSR gives d_xp within 1e-5 of the plain
    version's (both sums ending at the real edges, d_xp's padded rows
    unwritten)."""
    b = _batch(7, hub=200)
    rng = np.random.RandomState(9)
    H, C = 3, 60
    host = _triplet_inputs(rng, b, H, C)
    g = torch.from_numpy(rng.randn(b.num_nodes, H * C).astype(np.float32))
    csr = (b.csr_rowptr, b.csr_snd, b.csr_eid)
    snd = (b.snd_rowptr, b.snd_eid)

    def grads(dev):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in host]
        triplet_attention(*leaves, *(t.to(dev) for t in csr), H, C, 0.2,
                          *(t.to(dev) for t in snd)).backward(g.to(dev))
        return [a.grad for a in leaves]

    first, second, plain = grads(cuda), grads(cuda), grads("cpu")
    for name, x, y, z in zip(NAMES, first, second, plain):
        assert torch.equal(x, y), name
        torch.testing.assert_close(x.cpu(), z, rtol=1e-4, atol=1e-4,
                                   msg=name)


@pytest.mark.cuda
def test_flagship_trainer_twice_and_resumed_is_bitwise(cuda, tmp_path):
    """The flagship (the CLI's Dropout and RReLU, Adam, its step graphs)
    on 160 demo molecules: two runs of 2 epochs from one seed, and 1
    epoch, resume, 1 more: weights, Adam's state and the final line
    bitwise equal."""
    import shutil

    from chip_smoke import DEMO_CSV
    from glam_tpu_torch import run
    root = tmp_path / "demo"
    (root / "raw").mkdir(parents=True)
    lines = DEMO_CSV.read_text().splitlines()[:161]
    (root / "raw" / "demo.csv").write_text("\n".join(lines) + "\n")

    def cli(where, epochs, resume=None):
        data = tmp_path / f"data_{where}"
        shutil.copytree(root, data)
        argv = ["--dataset", "demo", "--dataset_root", str(data), "--loss",
                "bcel", "--mol_block", "_TripletMessage", "--epochs",
                str(epochs), "--batch_size", "16", "--scan_steps", "4",
                "--work_dir", str(tmp_path / where)]
        if resume is not None:
            argv += ["--resume", str(resume)]
        t = run.main(argv)
        last = (t.log_save_dir / "log.txt").read_text().strip() \
            .splitlines()[-1]
        return t, last

    a, last_a = cli("a", 2)
    b, last_b = cli("b", 2)
    c, _ = cli("c", 1)
    d, last_d = cli("d", 2, resume=c.log_save_dir)
    assert a.step_graphs is not None
    for other, last in ((b, last_b), (d, last_d)):
        assert last == last_a
        for (k, x), y in zip(a.model.state_dict().items(),
                             other.model.state_dict().values()):
            assert torch.equal(x, y), k
        for p, q in zip(a.model.parameters(), other.model.parameters()):
            sa, so = a.optimizer.state[p], other.optimizer.state[q]
            for k in sa:
                assert torch.equal(sa[k], so[k]), k
