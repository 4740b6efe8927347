"""The CUDA kernels against their plain torch versions: the
triplet-attention forward and backward (A, B) and the segment-softmax
SpMM forward and backward (kernel C); training steps of the model on
the card against the CPU; kernels A and B over a shard's halo table and
a node-sharded pair step of 2 ranks against the dense one; kernels A and
B over a CSR padded to the edge budget against its real slots, and the
trainer's steps as CUDA graphs (no host synchronisation in a step, 19
captured steps against eager, fresh noise and counted launches at every
replay; a data-parallel rank's steps through its segmented graphs on 2
gloo ranks).  Every test here is marked ``cuda`` and skips without a CUDA
device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Tolerance: rtol 1e-4, atol 1e-4 in float32.  The kernels sum each row's
edges in CSR order (a long row in 32-edge chunks, merged in order); the
plain versions sum with atomics in another order, and their softmax
divides after the sum.  Kernel B writes each edge's term of d_xp once and
the CSR-sum kernel adds them over the sender CSR, so every output of
kernels A and B, and of kernel C, is bitwise the same on every call.  Kernel C is
held against its plain versions computed in float64, so that the error
is the kernel's own.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (demo_csr, function_grads, kernel_inputs, random_csr,
                        random_segments, read_demo, rows_apart, spmm_inputs,
                        spmm_reference, stress_cases)
from glam_tpu_torch.data.graph import receiver_csr
from glam_tpu_torch.ops.kernels import common
from glam_tpu_torch.ops.kernels.segment_softmax_spmm import (
    segment_softmax_spmm, segment_softmax_spmm_bwd,
    segment_softmax_spmm_fwd)
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_bwd, triplet_attention_bwd_plain,
    triplet_attention_fwd, triplet_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tickets_left_zero(request):
    """After every test on the card: every ticket buffer of kernels A, B
    and C is all zero again (each kernel puts back the tickets it takes;
    one left nonzero makes a later call merge a long row early).  A dirty
    buffer fails the test that left it, names its entries and is zeroed,
    so that the tests after it are not blamed."""
    yield
    if "cuda" not in request.fixturenames or not torch.cuda.is_available():
        return
    torch.cuda.synchronize()
    dirty = common.dirty_tickets()
    if dirty:
        for key, buf in list(common._TICKETS.items()) + common._RETIRED:
            if key in dirty:
                buf.zero_()
        pytest.fail(f"{request.node.nodeid} left ticket buffers nonzero: "
                    f"{dirty}")


def _random_csr(rng, n_graphs=40):
    """Small random graphs, 64 empty rows and a receiver of in-degree
    300."""
    return random_csr(rng, n_graphs=n_graphs, max_n=30, tail=64, hub=300)


def _rows_csr(rng, lens, padded=0, fe=4):
    """A CSR with rows of ``lens`` edges from random senders, the edges'
    ids a permutation of the real ones, and ``padded`` edges after them
    that the CSR leaves out (zero features, as ``pad_graphs`` makes)."""
    rowptr = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=rowptr[1:])
    S = int(rowptr[-1])
    edge_attr = rng.randn(S + padded, fe).astype(np.float32)
    edge_attr[S:] = 0.0
    return (rowptr, rng.randint(0, len(lens), S).astype(np.int32),
            rng.permutation(S).astype(np.int32), edge_attr)


CASES = [
    ("demo128", 3, 60),       # the flagship serving shapes
    ("random", 3, 60),        # empty rows and a 300-edge receiver
    ("random", 5, 54),        # H*C = 270, the search space's widest
    ("random", 1, 8),
    ("random", 8, 64),        # H*C = 512, the kernels' maximum, 8 heads
    ("no_edges", 3, 60),      # E_real = 0 (a batch of methane)
    ("one_boundary", 3, 60),  # a 40-edge row across a 32-slot chunk
    ("many_blocks", 3, 60),   # a 3,000-edge row over 12 blocks of slots
    ("hub500", 3, 60),        # random_hub_empty: in-degree 500, 2,048 empty
    ("empty_runs", 3, 60),    # 200 empty rows in a row, 30 at the end
    ("padded", 3, 60),        # 37 padded edges after the real ones
    ("padded", 2, 5),         # H*C = 10, C not a multiple of 4
    ("random", 3, 15),        # the search's hid 15 and 90: one-lane path
    ("random", 3, 90),
    ("misaligned", 3, 60),    # xp not 16-byte aligned: one channel a group
]


def _case_csr(rng, case):
    if case == "demo128":
        return demo_csr(read_demo())
    if case in ("random", "misaligned"):
        return _random_csr(rng)
    if case == "hub500":
        return random_csr(rng)
    if case == "one_boundary":
        return _rows_csr(rng, np.r_[np.ones(20, int), 40,
                                    rng.randint(1, 5, 50)])
    if case == "many_blocks":
        return _rows_csr(rng, np.r_[rng.randint(0, 5, 100), 3000,
                                    rng.randint(0, 5, 100)])
    if case == "empty_runs":
        return _rows_csr(rng, np.r_[rng.randint(1, 9, 300),
                                    np.zeros(200, int),
                                    rng.randint(1, 9, 300),
                                    np.zeros(30, int)])
    if case == "padded":
        return _rows_csr(rng, rng.randint(0, 6, 300), padded=37)
    empty = np.zeros(0, np.int32)
    return receiver_csr(empty, empty, 9) + (np.zeros((4, 4), np.float32),)


def _case_inputs(rng, case, heads, channels, dev):
    csr = _case_csr(rng, case)
    args = kernel_inputs(rng, *csr, heads, channels, dev)
    if case == "misaligned":
        flat = torch.empty(args[0].numel() + 1, device=dev)
        flat[1:] = args[0].reshape(-1)
        args[0] = flat[1:].view(args[0].shape)
        assert args[0].data_ptr() % 16 and args[0].is_contiguous()
    return csr, args


def _rows_slots(csr, args):
    """``args`` with the CSR cut to its rows' slots, as the plain versions
    take it (a batch's CSR, ``demo128``'s, is padded to its edge
    budget)."""
    E = int(csr[0][-1])
    return args[:7] + [args[7][:E], args[8][:E]]


@pytest.mark.parametrize("case,heads,channels", CASES)
def test_kernel_matches_plain(cuda, case, heads, channels):
    """Kernel A against its plain version: the output and the row
    statistics, empty rows 0, and bitwise the same on a second call."""
    rng = np.random.RandomState(0)
    csr, args = _case_inputs(rng, case, heads, channels, cuda)
    before = triplet_attention.launches
    got = triplet_attention_fwd(*args, heads, channels)
    again = triplet_attention_fwd(*args, heads, channels)
    want = triplet_attention_plain(*_rows_slots(csr, args), heads, channels)
    torch.cuda.synchronize()
    assert triplet_attention.launches == before + 2
    N = len(csr[0]) - 1
    assert got[0].shape == want[0].shape == (N, heads * channels)
    for name, a, b in zip(("out", "row_max", "row_inv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    empty_rows = torch.from_numpy(np.diff(csr[0]) == 0).to(cuda)
    for a, b in zip(got, again):
        assert (a[empty_rows] == 0).all()
        assert torch.equal(a, b)


def test_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(1)
    csr = _random_csr(rng, n_graphs=3)
    args = kernel_inputs(rng, *csr, 6, 90, cuda)   # H*C = 540 > 512
    with pytest.raises(ValueError, match="exceeds its maximum"):
        triplet_attention(*args, 6, 90)
    args = kernel_inputs(rng, *csr, 3, 60, cuda)
    bad = list(args)
    bad[7] = bad[7].long()                          # int64 CSR
    with pytest.raises(TypeError, match="csr_snd"):
        triplet_attention(*bad, 3, 60)
    bad = list(args)
    bad[0] = bad[0].T.contiguous().T                # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        triplet_attention(*bad, 3, 60)
    bad = list(args)
    bad[1] = bad[1].cpu()                           # mixed devices
    with pytest.raises(ValueError, match="a_i is on cpu"):
        triplet_attention(*bad, 3, 60)


@pytest.mark.parametrize("case,heads,channels", CASES)
def test_backward_kernel_matches_plain(cuda, case, heads, channels):
    """Kernel B, fed kernel A's output and statistics, against its plain
    version fed the plain forward's; padded edges' rows zero without a
    fill; d_xp, d_eh, d_pre and d_a_i bitwise the same on a second
    call."""
    rng = np.random.RandomState(0)
    csr, args = _case_inputs(rng, case, heads, channels, cuda)
    N = args[0].shape[0]
    g = torch.from_numpy(rng.randn(N, heads * channels).astype(
        np.float32)).to(cuda)
    stats = triplet_attention_fwd(*args, heads, channels)
    rows = _rows_slots(csr, args)
    plain_stats = triplet_attention_plain(*rows, heads, channels)
    before = triplet_attention_bwd.launches
    got = triplet_attention_bwd(*args, *stats, g, heads, channels)
    again = triplet_attention_bwd(*args, *stats, g, heads, channels)
    want = triplet_attention_bwd_plain(*rows, *plain_stats, g, heads,
                                       channels)
    torch.cuda.synchronize()
    assert triplet_attention_bwd.launches == before + 2
    for name, a, b in zip(("d_xp", "d_eh", "d_pre", "d_a_i"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # padded edges (outside the CSR) and empty rows keep zeros
    in_csr = torch.zeros(args[3].shape[0], dtype=torch.bool, device=cuda)
    in_csr[rows[8].long()] = True
    assert (got[1][~in_csr] == 0).all() and (got[2][~in_csr] == 0).all()
    empty_rows = torch.from_numpy(np.diff(csr[0]) == 0).to(cuda)
    assert (got[3][empty_rows] == 0).all()


def test_backward_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(1)
    csr = _random_csr(rng, n_graphs=3)
    args = kernel_inputs(rng, *csr, 6, 90, cuda)   # H*C = 540 > 512
    g = torch.zeros_like(args[0])
    stats = [torch.zeros_like(args[1])] * 2
    with pytest.raises(ValueError, match="exceeds its maximum"):
        triplet_attention_bwd(*args, g, *stats, g, 6, 90)
    args = kernel_inputs(rng, *csr, 3, 60, cuda)
    out, *stats = triplet_attention_fwd(*args, 3, 60)
    g = torch.zeros_like(args[0]).T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="g must be contiguous"):
        triplet_attention_bwd(*args, out, *stats, g, 3, 60)
    with pytest.raises(ValueError, match="row_inv has shape"):
        triplet_attention_bwd(*args, out, stats[0], stats[1][:-1],
                              torch.zeros_like(out), 3, 60)


def _hold_function_grads(csr, H, C, rng, dev):
    """The autograd Function's gradients on the card (kernels A and B)
    against the same Function on the CPU in float64 (the plain
    versions), within rtol 1e-4 + atol 1e-5 x each tensor's scale; the
    rows apart, with their in-degree and chunks, on a failure.  The
    inputs are drawn from ``rng``."""
    host = kernel_inputs(rng, *csr, H, C, "cpu")
    g = torch.from_numpy(rng.randn(host[0].shape[0], H * C).astype(
        np.float32))
    card = function_grads(host, g, H, C, dev, torch.float32)
    want = function_grads(host, g, H, C, "cpu", torch.float64)
    for name, a, b in zip(("xp", "a_i", "a_j", "edge_attr", "we", "wemat"),
                          card, want):
        a = a.double()
        scale = max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * scale,
            msg=lambda m, name=name, a=a, b=b, scale=scale: (
                f"{name}: {m}\n" + (rows_apart(a, b, csr[0], 1e-4,
                                                1e-5 * scale)
                                     if name in ("xp", "a_i") else "")))


def test_function_gradients_match_cpu(cuda):
    """The autograd Function on the card (kernels A and B) against the
    same Function on the CPU (the plain versions) in float64.  The a_i
    gradient of a long row is the difference of two nearly equal sums
    (sum of alpha * dalpha and <g, out>); in float32 the CPU's own error
    there reached 4.6 times the tolerance on the card's host, in another
    order of its threaded sums on each run, where the card's stayed
    within 7e-7 of float64 (ROADMAP section C)."""
    rng = np.random.RandomState(2)
    csr = _random_csr(rng, n_graphs=20)
    _hold_function_grads(csr, 3, 60, rng, cuda)


@pytest.mark.parametrize("case", [c[0] for c in stress_cases()])
def test_long_row_gradients_match_float64(cuda, case):
    """The regression test of the a_i gradient fault: on each CSR with
    rows of 40-3,000 edges (the 3,000-edge row is the one whose float32
    CPU gradient lies 3.25 times the tolerance from float64), three
    times in a row, the card's gradients within the tolerance of the
    CPU's in float64, and the ticket buffers zero after each."""
    name, csr, H, C, seed = next(c for c in stress_cases() if c[0] == case)
    for _ in range(3):
        _hold_function_grads(csr, H, C, np.random.RandomState(seed), cuda)
        torch.cuda.synchronize()
        assert not common.dirty_tickets()


def test_model_step_trains_the_attention_on_the_card(cuda):
    """A training step of the flagship model on the card gives nonzero
    gradients to the attention's weights, which reach them only through
    kernel B."""
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.nn.model import Architecture, ModelConfig

    cfg = ModelConfig(mol_block="_TripletMessage", e_dim=64,
                      graph_norm="_PairNorm", graph_do="_None()",
                      end_do="_None()", pre_act="CELU", graph_act="CELU",
                      flat_act="CELU")
    model = Architecture(cfg, torch.Generator().manual_seed(0)).to(cuda)
    graphs = []
    for smi in read_demo()[:32]:
        x, snd, rcv, e = smiles_to_arrays(smi)
        graphs.append(GraphArrays(x, e, snd, rcv, np.zeros(1, np.float32)))
    batch = next(iter(GraphLoader(graphs, 32, 1))).to(cuda)
    before = triplet_attention_bwd.launches
    model.train()
    (model(batch) ** 2).mean().backward()
    torch.cuda.synchronize()
    assert triplet_attention_bwd.launches == before + cfg.message_steps
    conv = model.mol.conv.conv
    for name in ("weight_node", "weight_edge", "weight_triplet_att"):
        grad = getattr(conv, name).grad
        assert grad is not None and torch.isfinite(grad).all(), name
        assert grad.abs().max() > 0, name
    assert model.mol.lin0.linear.weight.grad.abs().max() > 0


# ------------------------------------------------------------ kernel C
SPMM_CASES = [
    ("random", 1, 60),        # the convs' and Set2Set's width
    ("random", 1, 120),       # GlobalLAPool's
    ("random", 3, 16),
    ("random", 8, 64),        # H*C = 512 with 8 heads, the maximum
    ("random", 1, 512),
    ("random", 1, 30),        # H*C not a multiple of 4: 4-byte copies
    ("random", 2, 30),        # C not a multiple of 4: one channel a group
    ("random", 1, 15),        # the search's hid 15 and 90, and 180 in
    ("random", 1, 90),        # GlobalLAPool at hid 90: 4-byte copies
    ("random", 1, 180),
    ("misaligned", 1, 60),    # values not 16-byte aligned: 4-byte copies
    ("long_row", 1, 60),      # one row of 5,000 entries
    ("one_boundary", 1, 60),  # a row crossing exactly one block boundary
    ("hundred_blocks", 1, 60),  # a row over more than 100 blocks
    ("serve_row", 1, 60),     # a 44,096-entry row, as serving's last node
    ("empty_runs", 1, 60),    # 200 empty rows in a row, 30 at rowptr == S
    ("unlisted", 2, 30),      # entries that no slot lists (S < M)
    ("empty_rows", 1, 60),    # rows, no entries
    ("no_rows", 1, 60),       # entries, no rows
]


def _lens_csr(rng, lens, unlisted=0):
    rowptr = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=rowptr[1:])
    S = int(rowptr[-1])
    return rowptr, rng.permutation(S + unlisted)[:S].astype(np.int32), \
        S + unlisted


def _spmm_case(rng, case):
    if case in ("random", "misaligned"):
        return random_segments(rng, n_rows=400, long_row=300,
                               empty_tail=50)
    if case == "long_row":
        return random_segments(rng, n_rows=60, long_row=5000, empty_tail=3)
    if case == "one_boundary":            # slots 250-269 are one row
        return _lens_csr(rng, np.r_[np.ones(250, int), 20,
                                    rng.randint(1, 5, 100)])
    if case == "hundred_blocks":          # 26,000 slots > 101 blocks
        return _lens_csr(rng, np.r_[rng.randint(0, 9, 100), 26000,
                                    rng.randint(0, 9, 100)])
    if case == "serve_row":
        return _lens_csr(rng, np.r_[rng.randint(0, 5, 3000),
                                    np.zeros(13700, int), 44096])
    if case == "empty_runs":
        return _lens_csr(rng, np.r_[rng.randint(1, 9, 300),
                                    np.zeros(200, int),
                                    rng.randint(1, 9, 300),
                                    np.zeros(30, int)])
    if case == "unlisted":
        return random_segments(rng, n_rows=200, long_row=100,
                               empty_tail=10, unlisted=37)
    if case == "empty_rows":
        return np.zeros(11, np.int32), np.zeros(0, np.int32), 0
    return np.zeros(1, np.int32), np.zeros(0, np.int32), 5


@pytest.mark.parametrize("case,heads,channels", SPMM_CASES)
def test_spmm_kernels_match_plain(cuda, case, heads, channels):
    """Each kernel C call against the float64 plain versions at 1e-4
    (the backward from the forward kernel's output and statistics),
    bitwise the same on a second call, empty rows and unlisted entries
    zero."""
    rng = np.random.RandomState(3)
    rowptr, idx, M = _spmm_case(rng, case)
    args = spmm_inputs(rng, rowptr, idx, M, heads, channels, cuda)
    if case == "misaligned":
        flat = torch.empty(args[1].numel() + 1, device=cuda)
        flat[1:] = args[1].reshape(-1)
        args[1] = flat[1:].view(args[1].shape)
        assert args[1].data_ptr() % 16 and args[1].is_contiguous()
    R = len(rowptr) - 1
    g = torch.from_numpy(rng.randn(R, heads * channels).astype(
        np.float32)).to(cuda)
    fwd, bwd = segment_softmax_spmm.launches, segment_softmax_spmm_bwd.launches
    got = segment_softmax_spmm_fwd(*args)
    want = spmm_reference(args)
    got_b = segment_softmax_spmm_bwd(*args, *got, g)
    want_b = spmm_reference(args, g)
    again = segment_softmax_spmm_fwd(*args)
    again_b = segment_softmax_spmm_bwd(*args, *again, g)
    torch.cuda.synchronize()
    assert segment_softmax_spmm.launches == fwd + 2 * int(R > 0)
    assert segment_softmax_spmm_bwd.launches == bwd + 2 * int(
        len(idx) > 0 and R > 0)
    assert got[0].shape == want[0].shape == (R, heads * channels)
    for name, a, b in zip(("out", "row_max", "row_inv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    empty_rows = torch.from_numpy(np.diff(rowptr) == 0).to(cuda)
    for t in got:
        assert (t[empty_rows] == 0).all()
    for name, a, b in zip(("d_logits", "d_values"), got_b, want_b):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
    listed = torch.zeros(M, dtype=torch.bool, device=cuda)
    listed[args[3].long()] = True
    assert (got_b[0][~listed] == 0).all() and (got_b[1][~listed] == 0).all()
    for a, b in zip(list(got) + list(got_b), list(again) + list(again_b)):
        assert torch.equal(a, b)


def test_spmm_function_gradients_match_cpu(cuda):
    rng = np.random.RandomState(4)
    rowptr, idx, M = random_segments(rng, n_rows=300, long_row=2000,
                                     empty_tail=20)
    host = spmm_inputs(rng, rowptr, idx, M, 3, 16, "cpu")
    g = torch.from_numpy(rng.randn(len(rowptr) - 1, 48).astype(np.float32))
    grads = {}
    # the CPU's plain versions in float64, the card's kernels in float32
    for dev, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        t = [a.detach().clone().to(dev) for a in host]
        for i in (0, 1):
            t[i] = t[i].to(dtype).requires_grad_(True)
        segment_softmax_spmm(*t).backward(g.to(dev, dtype))
        grads[str(dev)] = [a.grad.float().cpu() for a in t[:2]]
    for name, a, b in zip(("logits", "values"), grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


def test_spmm_kernel_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(5)
    rowptr, idx, M = random_segments(rng, n_rows=20, long_row=40,
                                     empty_tail=2)
    args = spmm_inputs(rng, rowptr, idx, M, 1, 513, cuda)   # H*C = 513
    with pytest.raises(ValueError, match="exceeds its maximum"):
        segment_softmax_spmm(*args)
    g = torch.zeros((len(rowptr) - 1, 513), device=cuda)
    stats = [torch.zeros((len(rowptr) - 1, 1), device=cuda)] * 2
    with pytest.raises(ValueError, match="exceeds its maximum"):
        segment_softmax_spmm_bwd(*args, g, *stats, g)
    args = spmm_inputs(rng, rowptr, idx, M, 1, 60, cuda)
    bad = list(args)
    bad[1] = bad[1].T.contiguous().T                 # not contiguous
    with pytest.raises(ValueError, match="values must be contiguous"):
        segment_softmax_spmm(*bad)
    bad = list(args)
    bad[3] = bad[3].long()                           # int64 idx
    with pytest.raises(TypeError, match="idx"):
        segment_softmax_spmm(*bad)
    bad = list(args)
    bad[0] = bad[0].double()                         # float64 logits
    with pytest.raises(TypeError, match="logits"):
        segment_softmax_spmm(*bad)
    g = torch.zeros((len(rowptr) - 1, 60), device=cuda)
    stats = [torch.zeros((len(rowptr) - 1, 1), device=cuda)] * 2
    with pytest.raises(ValueError, match="row_inv has shape"):
        segment_softmax_spmm_bwd(*args, g, stats[0], stats[1][:-1], g)


@pytest.mark.parametrize("block,readout", [
    ("_TripletMessageLight", "Set2Set"), ("_GATConv", "GlobalLAPool"),
    ("_NNConv", "GlobalPool5"), ("_GCNConv", "Set2Set")])
def test_new_conv_step_matches_cpu(cuda, block, readout):
    """One training-mode step (no noise) of a model with each new conv,
    _BatchNorm and _LayerNorm, on the card and on the CPU from the same
    weights: outputs, every parameter's gradient and the running
    statistics agree."""
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.nn.model import Architecture, ModelConfig

    cfg = ModelConfig(mol_block=block, mol_readout=readout, e_dim=64,
                      graph_norm="_BatchNorm", flat_norm="_LayerNorm",
                      end_norm="_BatchNorm", graph_do="_None()",
                      flat_do="_None()", end_do="_None()", pre_act="CELU",
                      graph_act="CELU", flat_act="CELU")
    graphs = []
    for smi in read_demo()[:32]:
        x, snd, rcv, e = smiles_to_arrays(smi)
        graphs.append(GraphArrays(x, e, snd, rcv, np.zeros(1, np.float32)))
    batch = next(iter(GraphLoader(graphs, 32, 1)))
    state = Architecture(cfg, torch.Generator().manual_seed(0)).state_dict()
    res = {}
    for dev in ("cpu", cuda):
        model = Architecture(cfg).to(dev)
        model.load_state_dict(state)
        model.train()
        out = model(batch.to(dev))
        (out ** 2).mean().backward()
        res[str(dev)] = (out.detach().cpu(),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()},
                         {n: b.cpu() for n, b in model.named_buffers()})
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    # a gradient that is zero in exact arithmetic (GlobalLAPool's gate
    # bias: a softmax does not move when every logit does) is rounding
    # noise: its scale is taken as at least 1e-2 of the tree's largest
    tree = max(float(g.abs().max()) for g in res["cpu"][1].values())
    for name, want in res["cpu"][1].items():
        scale = max(float(want.abs().max()), 1e-2 * tree)
        torch.testing.assert_close(res["cuda"][1][name], want, rtol=1e-3,
                                   atol=1e-4 * scale, msg=name)
    for name, want in res["cpu"][2].items():
        torch.testing.assert_close(res["cuda"][2][name], want, rtol=1e-4,
                                   atol=1e-4, msg=name)


# ------------------------------------------------------ the pair models
def _pair_batches(hetero):
    """A padded pair batch of the bundled corpora: 32 ddi_demo-style
    molecule pairs (demo SMILES), or 32 dti_demo (molecule, protein)
    pairs."""
    from pathlib import Path
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.data.batching import PairGraphLoader
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.data.pair_datasets import BindingDBDataset
    if hetero:
        root = Path(__file__).resolve().parents[1] / "datasets" / "dti_demo"
        pairs = BindingDBDataset(str(root)).train[:32]
    else:
        graphs = []
        for smi in read_demo()[:64]:
            x, snd, rcv, e = smiles_to_arrays(smi)
            graphs.append(GraphArrays(x, e, snd, rcv,
                                      np.ones(1, np.float32)))
        pairs = list(zip(graphs[:32], graphs[32:]))
    return next(iter(PairGraphLoader(pairs, 32, 1)))


@pytest.mark.parametrize("hetero", [False, True])
def test_pair_model_step_matches_cpu(cuda, hetero):
    """One training-mode step (no noise) of the pair model on the card and
    on the CPU from the same weights: the homo model with TripletMessage
    towers (kernels A and B 2 x 3 times), the hetero one with a GATConv
    protein tower (kernel C 3 times each way beside A and B 3 times);
    outputs and every parameter's gradient agree."""
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture

    cfg = ModelConfig(mol_block="_TripletMessage", pro_block="_GATConv",
                      e_dim=64, graph_norm="_PairNorm", graph_do="_None()",
                      flat_do="_None()", end_do="_None()", pre_act="CELU",
                      graph_act="CELU", flat_act="CELU", end_act="CELU",
                      max_nodes=132, pro_max_nodes=64)
    b1, b2 = _pair_batches(hetero)
    state = PairArchitecture(cfg, hetero,
                             torch.Generator().manual_seed(0)).state_dict()
    counted = (triplet_attention, triplet_attention_bwd,
               segment_softmax_spmm, segment_softmax_spmm_bwd)
    res = {}
    for dev in ("cpu", cuda):
        model = PairArchitecture(cfg, hetero).to(dev)
        model.load_state_dict(state)
        model.train()
        before = [k.launches for k in counted]
        out = model(b1.to(dev), b2.to(dev))
        (out ** 2).mean().backward()
        launches = [k.launches - n for k, n in zip(counted, before)]
        res[str(dev)] = (out.detach().cpu(),
                         {n: p.grad.cpu() for n, p in
                          model.named_parameters()})
    steps = cfg.message_steps
    assert launches == ([steps] * 4 if hetero else [2 * steps] * 2 + [0, 0])
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    tree = max(float(g.abs().max()) for g in res["cpu"][1].values())
    for name, want in res["cpu"][1].items():
        scale = max(float(want.abs().max()), 1e-2 * tree)
        torch.testing.assert_close(res["cuda"][1][name], want, rtol=1e-3,
                                   atol=1e-4 * scale, msg=name)


# ------------------------------------------- bfloat16 compute on the card
@pytest.mark.parametrize("block,readout", [
    ("_TripletMessage", "GlobalPool5"), ("_GATConv", "GlobalLAPool"),
    ("_TripletMessageLight", "Set2Set")])
def test_bf16_step_matches_cpu(cuda, tmp_path, block, readout):
    """One training-mode step (no noise) of the trainer at --dtype
    bfloat16, on the card and on the CPU from the same weights: the
    kernels run in float32 between casts; the output and every gradient
    agree within 5e-2 of the largest entry (the output's, the gradient
    tree's): bfloat16 keeps 8 bits of mantissa, and the card's and the
    CPU's bfloat16 matmuls round their partial sums differently.  The
    gradients and the masters are float32, and the kernels launched."""
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import featurize_smiles
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.nn.model import Architecture, ModelConfig
    from glam_tpu_torch.ops.kernels import launch_counts
    from glam_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(mol_block=block, mol_readout=readout, e_dim=64,
                      graph_norm="_BatchNorm", graph_do="_None()",
                      flat_do="_None()", end_do="_None()", pre_act="CELU",
                      graph_act="CELU", flat_act="CELU", end_act="CELU")
    graphs = []
    for smi in read_demo()[:32]:
        x, snd, rcv, e = featurize_smiles(smi)
        graphs.append(GraphArrays(x, e, snd, rcv, np.ones(1, np.float32)))
    batch = next(iter(GraphLoader(graphs, 32, 1)))
    state = Architecture(cfg, torch.Generator().manual_seed(0)).state_dict()
    args = {"dtype": "bfloat16", "loss": "bcel", "task": "binary_nan_bce",
            "num_tasks": 1}
    res = {}
    before = sum(launch_counts().values())
    for dev in ("cpu", "cuda"):
        model = Architecture(cfg)
        model.load_state_dict(state)
        tr = Trainer(args, model, [], [], print_log=False,
                     work_dir=str(tmp_path / dev), device=dev)
        tr.model.train()
        parts = tr._to_device(batch)
        out = tr.forward(parts)
        tr.loss_fn(out, parts[0].y, parts[0].graph_mask).backward()
        assert out.dtype == torch.float32
        grads = {}
        for n, p in tr.model.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, n
            grads[n] = p.grad.cpu()
        res[dev] = (out.detach().cpu(), grads)
    assert sum(launch_counts().values()) > before
    scale = float(res["cpu"][0].abs().max())
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=0,
                               atol=5e-2 * scale)
    tree = max(float(g.abs().max()) for g in res["cpu"][1].values())
    for name, want in res["cpu"][1].items():
        torch.testing.assert_close(res["cuda"][1][name], want, rtol=0,
                                   atol=5e-2 * tree, msg=name)


def test_native_featurizer_on_the_cards_machine():
    """The C++ featurizer builds with this machine's g++ and matches the
    Python featurizer byte for byte on the demo corpus."""
    from glam_tpu_torch.chem.featurize import smiles_to_arrays
    from glam_tpu_torch.chem.native import smiles_to_arrays_native
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for smi in read_demo():
        try:
            want = smiles_to_arrays(smi)
        except ValueError:
            with pytest.raises(ValueError):
                smiles_to_arrays_native(smi)
            continue
        got = smiles_to_arrays_native(smi)
        assert all(g.dtype == w.dtype and g.shape == w.shape
                   and g.tobytes() == w.tobytes()
                   for g, w in zip(got, want)), smi


def test_inference_is_bitwise_reproducible(cuda):
    """Inference on the card gives the same bits on every call: the
    segment sums (GCN's aggregation, the graph norms, GlobalPool5) sum
    each segment in a fixed order in the CSR-sum kernel, where
    ``index_add_``'s atomics would not; and they agree with the CPU's
    ``index_add_`` within 1e-5 (summation order)."""
    from glam_tpu_torch.data.batching import GraphLoader
    from glam_tpu_torch.data.datasets import featurize_smiles
    from glam_tpu_torch.data.graph import GraphArrays
    from glam_tpu_torch.nn.model import Architecture, ModelConfig
    from glam_tpu_torch.ops.segment import segment_sum

    g = torch.Generator().manual_seed(4)
    data = torch.randn((20000, 60), generator=g)
    ids = torch.randint(0, 300, (20000,), generator=g)
    with torch.no_grad():
        a = segment_sum(data.to(cuda), ids.to(cuda), 301)
        b = segment_sum(data.to(cuda), ids.to(cuda), 301)
    assert torch.equal(a, b)
    want = torch.zeros((301, 60)).index_add_(0, ids, data)
    torch.testing.assert_close(a.cpu(), want, rtol=1e-5, atol=1e-5)

    graphs = []
    for smi in read_demo()[:64]:
        x, snd, rcv, e = featurize_smiles(smi)
        graphs.append(GraphArrays(x, e, snd, rcv, np.ones(1, np.float32)))
    batch = next(iter(GraphLoader(graphs, 64, 1))).to(cuda)
    for block, readout, norm in (("_GCNConv", "Set2Set", "_LayerNorm"),
                                 ("_TripletMessage", "GlobalPool5",
                                  "_PairNorm")):
        cfg = ModelConfig(mol_block=block, mol_readout=readout, e_dim=256,
                          graph_norm=norm)
        model = Architecture(cfg, torch.Generator().manual_seed(0)).to(
            cuda).eval()
        with torch.inference_mode():
            outs = [model(batch) for _ in range(3)]
        assert all(torch.equal(outs[0], o) for o in outs[1:]), block


def test_dp_step_with_two_ranks_on_one_card(cuda, tmp_path):
    """One data-parallel SGD step of 2 gloo ranks sharing cuda:0
    (``tests/torch_port_dp_worker.py``) against one process's step of the
    global batch on the card, noise off: the parameters within rtol 1e-4
    + atol 1e-6 x each tensor's scale (the gradient sums over ranks run
    in another order), and the merged evaluation within 1e-5."""
    import json

    import torch_port_dp_worker as worker
    from torch_port_dp_worker import spawn_ranks, wait_ranks

    for name in worker.CONFIGS:
        _, cfg = worker.config_args(name, 1)
        torch.save(worker.Architecture(
            cfg, torch.Generator().manual_seed(7)).state_dict(),
            tmp_path / f"init_{name}.pt")
    (tmp_path / "plan.json").write_text(json.dumps({"tasks": ["step"],
                                                    "platform": "cuda"}))
    procs = spawn_ranks(tmp_path, "cuda")
    single = worker.step_and_eval(worker.trainer("flagship", 1, tmp_path,
                                                 cuda))
    got = wait_ranks(procs, tmp_path)["step_flagship"]
    for k, want in single["state"].items():
        scale = max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got["state"][k], want, rtol=1e-4,
                                   atol=1e-6 * scale, msg=k)
    np.testing.assert_allclose(got["out"], single["out"], rtol=1e-5,
                               atol=1e-5)
    assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)


def test_triplet_kernels_over_a_halo_table(cuda):
    """Kernels A and B as the node-sharded TripletMessage tower calls
    them: ``xp`` is a shard's [local ; halo] table, the halo rows are
    empty CSR rows (their a_i zero), the CSR's slots padded to the
    shard's edge slots (past ``csr_rowptr[-1]``, as the batch's are),
    against the plain versions over the real slots in float64; B's d_xp
    reaches the halo rows."""
    from chip_smoke import sharded_protein_cases, shard_kernel_inputs
    H, C = 3, 60
    cases = sharded_protein_cases(length=300, e_dim=32, time=False)
    shard = shard_kernel_inputs(cases["protein300_TripletMessage"])
    R = shard.n_pairs * shard.n_local
    csr = (shard.csr_rowptr.numpy(), shard.csr_snd.numpy(),
           shard.csr_eid.numpy(), shard.edges.numpy())
    assert shard.halo_rows > 0 and (np.diff(csr[0])[R:] == 0).all()
    rng = np.random.RandomState(3)
    args = kernel_inputs(rng, *csr, H, C, cuda)
    args[1][R:] = 0
    T = args[0].shape[0]
    g = torch.from_numpy(rng.randn(T, H * C).astype(np.float32)).to(cuda)
    got = triplet_attention_fwd(*args, H, C)
    got_b = triplet_attention_bwd(*args, *got, g, H, C)
    E = int(csr[0][-1])
    assert csr[1].shape[0] == shard.edges.shape[0] > E
    d64 = [a.cpu().double() if a.is_floating_point() else a.cpu()
           for a in args[:7] + [args[7][:E], args[8][:E]]]
    want = triplet_attention_plain(*d64, H, C)
    want_b = triplet_attention_bwd_plain(*d64, *want, g.cpu().double(), H,
                                         C)
    for name, a, b in zip(("out", "row_max", "row_inv", "d_xp", "d_eh",
                           "d_pre", "d_a_i"), got + got_b, want + want_b):
        torch.testing.assert_close(a.cpu().double(), b, rtol=1e-4,
                                   atol=1e-4, msg=name)
    assert float(got_b[0][R:].abs().max()) > 0      # the halo rows' grads
    assert (got[0][R:] == 0).all()


def test_sharded_pair_step_with_two_ranks_on_one_card(cuda, tmp_path):
    """One sharded pair step of 2 gloo ranks on cuda:0
    (``tests/torch_port_dp_worker.py``, task ``sharded``) against the
    dense model's on the card, a 300-residue protein with GAT and
    TripletMessage towers, a2a and ring: the output within 1e-4, every
    gradient within rtol 2e-4 + atol 5e-5 x its leaf's scale; after one
    Adam step both ranks' parameters are bitwise equal."""
    from chip_smoke import dense_pair_reference, sharded_protein_cases
    from torch_port_dp_worker import spawn_ranks, wait_ranks
    cases = sharded_protein_cases(length=300, e_dim=64, time=False)
    torch.save(cases, tmp_path / "sharded.pt")
    (tmp_path / "plan.json").write_text('{"tasks": ["sharded"]}')
    procs = spawn_ranks(tmp_path, "cuda")
    dense = {name: dense_pair_reference(case, cuda)
             for name, case in cases.items()}
    got = wait_ranks(procs, tmp_path, timeout=600)["sharded"]
    for name, (out, grads) in dense.items():
        for halo in ("a2a", "ring"):
            r = got[name][halo]
            torch.testing.assert_close(r["out"], out, rtol=1e-4, atol=1e-4)
            for k, want in grads.items():
                scale = max(float(want.abs().max()), 1.0)
                torch.testing.assert_close(r["grads"][k], want, rtol=2e-4,
                                           atol=5e-5 * scale,
                                           msg=f"{name} {halo} {k}")
        states = got[name]["adam"]
        for k in states[0]:
            assert torch.equal(states[0][k], states[1][k]), k


# ------------------------------------------------- the captured steps
@pytest.fixture(scope="module")
def flagship_trainer(tmp_path_factory):
    """The flagship (TripletMessage H=3, 3 steps, e_dim 1024, Adam, the
    CLI's Dropout and RReLU) on the demo corpus, on the card, untrained;
    its ``step_graphs`` made by the trainer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import shutil

    from chip_smoke import DEMO_CSV
    from glam_tpu_torch.data.datasets import auto_dataset
    from glam_tpu_torch.run import build_parser
    from glam_tpu_torch.train.pair_trainer import make_auto_trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tmp_path_factory.mktemp("graphs")
    shutil.copytree(DEMO_CSV.parent, tmp / "demo" / "raw")
    args = vars(build_parser().parse_args([
        "--dataset", "demo", "--dataset_root", str(tmp / "demo"),
        "--loss", "bcel", "--mol_block", "_TripletMessage", "--epochs", "1",
        "--work_dir", str(tmp)]))
    args, ds, kind = auto_dataset(args)
    return make_auto_trainer(args, ds, kind, work_dir=str(tmp),
                             device="cuda")


def test_triplet_kernels_over_the_budget_csr(cuda):
    """Kernels A and B at a training batch's CSR, padded to the edge
    budget, against the same CSR cut to its real slots: A's outputs and
    every output of B bitwise equal (the padded slots add zero rows at the
    end of the last node's sender row)."""
    from chip_smoke import demo_batch
    b = demo_batch(read_demo(), 32)
    E = int(b.csr_rowptr[-1])
    assert b.csr_snd.shape[0] == b.num_edges > E
    rng = np.random.RandomState(12)
    H, C = 3, 60
    args = kernel_inputs(rng, b.csr_rowptr.numpy(), b.csr_snd.numpy(),
                         b.csr_eid.numpy(), b.edges.numpy(), H, C, cuda)
    real = args[:7] + [args[7][:E], args[8][:E]]
    g = torch.from_numpy(rng.randn(b.num_nodes, H * C).astype(
        np.float32)).to(cuda)
    fwd = [triplet_attention_fwd(*a, H, C) for a in (args, real)]
    for x, y in zip(*fwd):
        assert torch.equal(x, y)
    bwd = [triplet_attention_bwd(*a, *fwd[0], g, H, C) for a in (args, real)]
    for x, y in zip(*bwd):
        assert torch.equal(x, y)


def test_eager_step_makes_no_host_synchronisation(cuda, flagship_trainer):
    """A training step and an evaluation forward on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in them waits
    for the device, which is what lets a CUDA graph hold them."""
    t = flagship_trainer
    parts = t._to_device(next(iter(t.train_loader)))
    t.model.train()
    t._step(parts)                  # the optimizer's state, made once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t._step(parts)
        t.model.eval()
        with torch.inference_mode():
            t._eval_step(parts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        t.model.train()


def test_captured_flagship_step_matches_eager(cuda, flagship_trainer):
    """2 x 8 + 3 steps through the graphs and eagerly from one state (the
    smoke's check, ``chip_smoke.captured_vs_eager``): parameters,
    optimizer state and launches; with the trainer's noise the losses say
    that the replays draw the eager steps' masks and slopes."""
    from chip_smoke import captured_vs_eager
    for noise in (False, True):
        r = captured_vs_eager("flagship", flagship_trainer, "test",
                              noise=noise)
        assert r["same_draws"]


def test_replays_draw_fresh_noise_and_count_their_launches(
        cuda, flagship_trainer):
    """Replays of the one-step graph on one batch at learning rate 0: the
    loss moves with each replay's fresh Dropout masks and RReLU slopes;
    kernel A's and B's counts grow by 3 a replay; the tickets are zero
    after them."""
    from glam_tpu_torch.ops.kernels import launch_counts
    from glam_tpu_torch.train.optim import set_learning_rate
    from glam_tpu_torch.train.step_graph import StepGraphs
    t = flagship_trainer
    t.model.train()
    host = t._as_parts(next(iter(t.train_loader)))
    set_learning_rate(t.optimizer, 0.0)
    graphs = StepGraphs(t._step, t._eval_step, t.device, t.generator)
    graphs.train([host], False)              # the warm-up step, eager
    before = launch_counts()
    losses = torch.cat([graphs.train([host], False) for _ in range(4)])
    after = launch_counts()
    set_learning_rate(t.optimizer, 1e-3)
    assert graphs.stats["captures"] == 1 and graphs.stats["replays"] == 4
    assert after["triplet_fused_fwd"] - before["triplet_fused_fwd"] == 12
    assert after["triplet_fused_bwd"] - before["triplet_fused_bwd"] == 12
    assert len(set(losses.tolist())) == 4
    torch.cuda.synchronize()
    assert common.dirty_tickets() == {}


def test_dp_step_graphs_with_two_ranks_on_one_card(cuda, tmp_path):
    """The data-parallel steps of 2 gloo ranks sharing cuda:0 through
    their step graphs (the segmented design: two graphs a step around
    one eager all-reduce) against the same steps eagerly, 19 steps from
    one state with the learning rate cut between (``chip_smoke.
    hold_bitwise``, bitwise): SGD without noise, and Adam with RReLU and
    Dropout, whose losses say that each replay draws its eager step's
    masks from the reseeded generator; launches equal; the ranks bitwise
    equal."""
    import json
    import shutil

    from chip_smoke import DEMO_CSV, DP_GRAPH_CONFIGS, hold_bitwise
    from torch_port_dp_worker import GRAPH_PLAN, spawn_ranks, wait_ranks
    shutil.copytree(DEMO_CSV.parent, tmp_path / "demo" / "raw")
    small = {"e_dim": 128, "hid_dim_alpha": 2}
    (tmp_path / "plan.json").write_text(json.dumps({
        "tasks": ["graphs"], "root": str(tmp_path / "demo"),
        "graphs": {k: dict(v, **small) for k, v in
                   DP_GRAPH_CONFIGS.items()}}))
    got = wait_ranks(spawn_ranks(tmp_path, "cuda"), tmp_path,
                     timeout=600)["graphs"]
    for name, r in got.items():
        runs = r["runs"]
        res = hold_bitwise(f"dp {name}", DP_GRAPH_CONFIGS[name]["optim"],
                           "noise" in name, GRAPH_PLAN, runs, "test")
        assert res["same_draws"]
        assert runs["captured"][3]["replays"] > 0
        states = r["captured_by_rank"]
        for k in states[0]:
            assert torch.equal(states[0][k], states[1][k]), k
