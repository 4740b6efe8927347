"""The port's triplet-attention backward against the JAX package:
``triplet_attention_bwd_plain``, fed the plain forward's output and row
statistics, and the ``autograd.Function`` around it against ``jax.vjp``
of the Pallas ``fused_triplet_attention`` (interpret mode) and of
``triplet_attention_reference``; ``gradcheck`` of the Function in
float64; and the model's whole parameter-gradient tree against
``jax.grad`` of the JAX ``Architecture`` with converted weights.

Tolerances: the backward at atol 1e-5 plus rtol 1e-5 (float32 sums in
another order; d_We and d_wemat sum over every edge, so their entries
reach ~1e2 and carry ~1e-7 relative rounding), rtol 1e-4 on a hub row of
in-degree 300 and at H*C 270 and 512, where the JAX package's float32
d_We is itself 3.5e-5 from its float64 one; the gradient tree at
rtol 5e-4, atol 1e-6, as tests/test_torch_twin.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import model as jax_model
from glam_tpu.ops.pallas.triplet_fused import (fused_triplet_attention,
                                               pack_blocks2,
                                               triplet_attention_reference)
from glam_tpu.train.trainer import make_loss_fn as jax_loss_fn
from glam_tpu_torch import convert
from glam_tpu_torch.data.graph import receiver_csr
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_bwd, triplet_attention_bwd_plain,
    triplet_attention_plain)
from glam_tpu_torch.train.trainer import make_loss_fn as port_loss_fn
from test_torch_port_model import _cfg, _np_tree, _port_batch

NAMES = ("xp", "a_i", "a_j", "edge_attr", "we", "wemat")
PAD = 5         # padded edges: last node -> last node, zero features


def _graph(rng, case):
    """(senders, receivers, N) of the real edges: small random graphs with
    a receiver of in-degree 60 ('random') or 300 ('hub') and 8 isolated
    nodes (empty rows), or no edges at all."""
    if case == "no_edges":
        empty = np.zeros(0, np.int32)
        return empty, empty, 12
    hub = 300 if case == "hub" else 60
    off, snd, rcv = 0, [], []
    for gi in range(8):
        n = rng.randint(4, 20)
        e = rng.randint(3, 3 * n)
        snd.extend((rng.randint(0, n, e) + off).tolist())
        rcv.extend((rng.randint(0, n, e) + off).tolist())
        if gi == 0:
            snd.extend((rng.randint(0, n, hub) + off).tolist())
            rcv.extend([off + 1] * hub)
        off += n
    return (np.asarray(snd, np.int32), np.asarray(rcv, np.int32), off + 8)


def _inputs(rng, N, E, H, C, dtype=np.float32):
    w_e = rng.randn(H, C)
    wemat = np.zeros((H * C, H))
    for h in range(H):
        wemat[h * C:(h + 1) * C, h] = w_e[h]
    edge_attr = rng.randn(E, 4)
    edge_attr[E - PAD:] = 0.0
    arrays = [rng.randn(N, H * C), rng.randn(N, H), rng.randn(N, H),
              edge_attr, rng.randn(4, H * C) * 0.3, wemat]
    return [a.astype(dtype) for a in arrays]


@pytest.mark.parametrize("case", ["random", "no_edges"])
@pytest.mark.parametrize("heads,channels", [(3, 60), (2, 5), (4, 8)])
def test_backward_matches_jax(case, heads, channels):
    _check_backward(case, heads, channels, rtol=1e-5)


@pytest.mark.parametrize("case,heads,channels", [
    ("hub", 3, 60),           # a receiver of in-degree 300
    ("random", 5, 54),        # H*C = 270
    ("random", 8, 64),        # H*C = 512, 8 heads
    ("no_edges", 8, 64)])
def test_backward_matches_jax_hub_and_wide(case, heads, channels):
    """At rtol 1e-4: d_We sums over every edge, and at these shapes the
    JAX package's own float32 gradient is 3.5e-5 from its float64 one."""
    _check_backward(case, heads, channels, rtol=1e-4)


def _check_backward(case, heads, channels, rtol):
    H, C = heads, channels
    rng = np.random.RandomState(7)
    snd, rcv, N = _graph(rng, case)
    E_real = len(snd)
    snd_all = np.concatenate([snd, np.full(PAD, N - 1, np.int32)])
    rcv_all = np.concatenate([rcv, np.full(PAD, N - 1, np.int32)])
    host = _inputs(rng, N, E_real + PAD, H, C)
    g = rng.randn(N, H * C).astype(np.float32)
    g[-1] = 0.0         # the padding node's cotangent, as in the model

    rowptr, csr_snd, csr_eid = (torch.from_numpy(a) for a in receiver_csr(
        snd, rcv, N))
    t = [torch.from_numpy(a) for a in host]
    stats = triplet_attention_plain(*t, rowptr, csr_snd, csr_eid, H, C)
    d_xp, d_eh, d_pre, d_a_i = triplet_attention_bwd_plain(
        *t, rowptr, csr_snd, csr_eid, *stats, torch.from_numpy(g), H, C)
    assert (d_eh[E_real:] == 0).all() and (d_pre[E_real:] == 0).all()
    leaves = [a.clone().requires_grad_(True) for a in t]
    before = triplet_attention_bwd.launches
    triplet_attention(*leaves, rowptr, csr_snd, csr_eid, H, C).backward(
        torch.from_numpy(g))
    assert triplet_attention_bwd.launches == before   # no kernel on the CPU
    got = dict(zip(NAMES, (a.grad.numpy() for a in leaves)))
    np.testing.assert_array_equal(got["xp"], d_xp.numpy())
    np.testing.assert_array_equal(got["a_i"], d_a_i.numpy())

    j = [jnp.asarray(a) for a in host]

    def reference(*a):
        return triplet_attention_reference(
            *a, jnp.asarray(snd_all), jnp.asarray(rcv_all), H, C)

    _, vjp = jax.vjp(reference, *j)
    want = dict(zip(NAMES, (np.asarray(x) for x in vjp(jnp.asarray(g)))))
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=1e-5, err_msg=f"reference {name}")

    if case in ("no_edges", "hub"):
        return      # the Pallas packing needs an edge, and 256 a row at most
    pk = pack_blocks2(snd, rcv, N)
    packed = [jnp.asarray(v) for v in (pk.perm, pk.local_rcv, pk.local_snd,
                                       pk.win_start, pk.edge_mask)]
    j_real = j[:3] + [j[3][:E_real]] + j[4:]

    def fused(*a):
        return fused_triplet_attention(H, C, 0.2, True, *a, jnp.asarray(snd),
                                       jnp.asarray(rcv), *packed)

    _, vjp = jax.vjp(fused, *j_real)
    want = dict(zip(NAMES, (np.asarray(x) for x in vjp(jnp.asarray(g)))))
    got["edge_attr"] = got["edge_attr"][:E_real]
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=1e-5, err_msg=f"Pallas {name}")


def test_gradcheck_float64():
    """Finite differences of the Function (plain forward and backward) in
    float64 on a tiny graph with an empty row and a padded edge."""
    snd = np.asarray([1, 2, 0, 3, 2, 4], np.int32)
    rcv = np.asarray([0, 0, 1, 2, 2, 2], np.int32)
    N, H, C = 6, 2, 3
    rowptr, csr_snd, csr_eid = (torch.from_numpy(a) for a in receiver_csr(
        snd, rcv, N))
    rng = np.random.RandomState(3)
    host = _inputs(rng, N, len(snd) + PAD, H, C, np.float64)
    inputs = tuple(torch.from_numpy(a).requires_grad_(True) for a in host)
    assert torch.autograd.gradcheck(
        lambda *a: triplet_attention(*a, rowptr, csr_snd, csr_eid, H, C),
        inputs, eps=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def batches(request):
    sample_graphs = request.getfixturevalue("sample_graphs")
    return (next(iter(JaxLoader(sample_graphs, batch_size=6, num_tasks=1))),
            _port_batch(SMILES_SET))


@pytest.mark.parametrize("norm", ["_None", "_PairNorm"])
def test_model_gradient_tree_matches_jax(batches, norm):
    """The whole parameter-gradient tree of a training-mode step without
    noise (CELU, no dropout), against jax.grad with converted weights."""
    jb, pb = batches
    kw = dict(graph_norm=norm, pre_norm=norm, graph_do="_None()",
              end_do="_None()")
    cfg_j = _cfg(jax_model.ModelConfig, **kw)
    model_j = jax_model.Architecture(cfg_j)
    params = model_j.init(jax.random.PRNGKey(4), jb, True)["params"]
    loss_j = jax_loss_fn("regression", "mse", 1)

    def objective(p):
        out = model_j.apply({"params": p}, jb, False)
        return loss_j(out, jb.y, jb.graph_mask)

    grads_j = convert.state_dict_from_jax(
        _np_tree(jax.grad(objective)(params)), _cfg(port_model.ModelConfig,
                                                    **kw))
    cfg_t = _cfg(port_model.ModelConfig, **kw)
    model_t = port_model.Architecture(cfg_t)
    model_t.load_state_dict(convert.state_dict_from_jax(_np_tree(params),
                                                        cfg_t))
    model_t.train()
    port_loss_fn("regression", "mse", 1)(model_t(pb), pb.y,
                                         pb.graph_mask).backward()
    grads_t = dict(model_t.named_parameters())
    assert set(grads_t) == set(grads_j)
    for name, want in grads_j.items():
        got = grads_t[name].grad
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                                   atol=1e-6, err_msg=name)
