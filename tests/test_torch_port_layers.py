"""The port's convs, norms and readouts, each against its JAX module with
the weights carried over by ``convert``, on one padded batch of the
conftest molecules: every row is compared, the padding graph's and the
padding nodes' included, at rtol 1e-5 / atol 2e-5 (float32 sums in
another order).  BatchNorm in training mode over 3 weight-tied calls:
the outputs and the running ``mean``/``var`` against JAX's mutable
``batch_stats``; in eval mode it normalises with them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import convs as jax_convs
from glam_tpu.nn import norms as jax_norms
from glam_tpu.nn import readouts as jax_readouts
from glam_tpu_torch import convert
from glam_tpu_torch.nn import convs, norms, readouts
from test_torch_port_model import _np_tree, _port_batch

TOL = dict(rtol=1e-5, atol=2e-5)
C = 12


@pytest.fixture(scope="module")
def batches(request):
    jb = next(iter(JaxLoader(request.getfixturevalue("sample_graphs"),
                             batch_size=6, num_tasks=1)))
    pb = _port_batch(SMILES_SET)
    # padded edges exist and point at the last (padding) node
    assert pb.num_real_edges < pb.num_edges
    assert bool(pb.node_mask[-1]) is False
    return jb, pb


def _x(rows, width=C, seed=0):
    return np.random.RandomState(seed).randn(rows, width).astype(np.float32)


def _load(module, params):
    module.load_state_dict(convert.convert_tree(
        _np_tree(params), dict(module.named_parameters())))
    return module


@pytest.mark.parametrize("name", ["_TripletMessageLight", "_NNConv",
                                  "_GCNConv", "_GATConv"])
def test_conv_matches_jax(batches, name):
    jb, pb = batches
    fe = pb.edges.shape[1]
    x = _x(pb.num_nodes)
    mod_j = jax_convs.get_conv(name, C, C, fe)
    args = (jnp.asarray(x), jb.edges, jb.senders, jb.receivers)
    params = mod_j.init(jax.random.PRNGKey(1), *args)["params"]
    want = np.asarray(mod_j.apply({"params": params}, *args))
    mod_t = _load(convs.get_conv(name, C, C, fe), params)
    got = mod_t(torch.from_numpy(x), pb).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the padding node, which receives every padded edge, is compared
    # too; its row is not trivially zero for these convs
    assert np.abs(want[-1]).max() > 0


def test_padded_edge_csrs(batches):
    """padded_csr is the receiver CSR of every edge slot; self_loop_csr
    adds one loop per node, first in its row."""
    from glam_tpu_torch.data.graph import receiver_csr
    _, pb = batches
    rowptr, idx = pb.padded_csr
    want_ptr, _, want_idx = receiver_csr(pb.senders.numpy(),
                                         pb.receivers.numpy(), pb.num_nodes)
    np.testing.assert_array_equal(rowptr.numpy(), want_ptr)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    loop_ptr, loop_idx = pb.self_loop_csr
    N, E = pb.num_nodes, pb.num_edges
    np.testing.assert_array_equal(loop_ptr.numpy(),
                                  want_ptr + np.arange(N + 1))
    assert sorted(loop_idx.tolist()) == list(range(E + N))
    np.testing.assert_array_equal(loop_idx[loop_ptr[:-1].long()].numpy(),
                                  E + np.arange(N))


def _norm_kwargs(jb, pb, graphs):
    if not graphs:
        return {}, {}
    return (dict(node_graph=jb.node_graph, n_node=jb.n_node,
                 node_mask=jb.node_mask),
            dict(node_graph=pb.node_graph, n_node=pb.n_node,
                 node_mask=pb.node_mask))


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("name", ["_LayerNorm", "_GraphSizeNorm"])
def test_stateless_norm_matches_jax(batches, name, graphs):
    jb, pb = batches
    x = _x(pb.num_nodes, seed=2) * 3 + 1
    kw_j, kw_t = _norm_kwargs(jb, pb, graphs)
    mod_j = jax_norms.get_norm(name, C)
    variables = mod_j.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw_j)
    params = variables.get("params", {})
    if params:   # a scale and bias away from their initial ones and zeros
        params = jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(np.random.RandomState(5).randn(
                *a.shape), a.dtype), params)
    want = np.asarray(mod_j.apply({"params": params}, jnp.asarray(x),
                                  **kw_j))
    mod_t = _load(norms.get_norm(name, C), params)
    got = mod_t(torch.from_numpy(x), **kw_t).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("masked", [True, False])
def test_batch_norm_three_tied_steps_match_jax(batches, masked):
    """Train mode, one module called 3 times in a row as the weight-tied
    MessageBlock calls it: each call normalises with the batch's biased
    variance over the real rows (or all rows without a mask) and moves
    the running statistics (momentum 0.1, unbiased variance), seeing the
    previous call's update.  Eval mode then uses those statistics."""
    jb, pb = batches
    x = _x(pb.num_nodes, seed=3) * 2 + 0.5
    kw_j, kw_t = _norm_kwargs(jb, pb, True)
    if not masked:
        kw_j, kw_t = {}, {}
    mod_j = jax_norms.BatchNorm(features=C)
    variables = mod_j.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw_j)
    mod_t = norms.BatchNorm(C)
    state = convert.convert_tree(_np_tree(variables["params"]),
                                 dict(mod_t.named_parameters()))
    mod_t.load_state_dict(state, strict=False)
    mod_t.train()
    params, stats = variables["params"], variables["batch_stats"]
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for step in range(3):
        xj, upd = mod_j.apply({"params": params, "batch_stats": stats}, xj,
                              use_running_average=False, mutable=[
                                  "batch_stats"], **kw_j)
        stats = upd["batch_stats"]
        xt = mod_t(xt, **kw_t)
        np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj),
                                   err_msg=f"call {step}", **TOL)
        np.testing.assert_allclose(mod_t.mean.numpy(),
                                   np.asarray(stats["mean"]), **TOL)
        np.testing.assert_allclose(mod_t.var.numpy(),
                                   np.asarray(stats["var"]), **TOL)
    mod_t.eval()
    want = np.asarray(mod_j.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), **kw_j))
    got = mod_t(torch.from_numpy(x), **kw_t).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert set(mod_t.state_dict()) == {"scale", "bias", "mean", "var"}


@pytest.mark.parametrize("name", ["GlobalLAPool", "Set2Set"])
def test_readout_matches_jax(batches, name):
    jb, pb = batches
    x = _x(pb.num_nodes, seed=4)
    mod_j, mult_j = jax_readouts.get_readout(name, C, 32)
    args = (jnp.asarray(x), jb.node_graph, jb.node_pos, jb.n_node)
    params = mod_j.init(jax.random.PRNGKey(2), *args)["params"]
    want = np.asarray(mod_j.apply({"params": params}, *args))
    mod_t, mult_t = readouts.get_readout(name, C, 32)
    _load(mod_t, params)
    got = mod_t(torch.from_numpy(x), pb.node_graph, pb.node_pos,
                pb.n_node).detach().numpy()
    assert mult_t == mult_j and got.shape == (pb.num_graphs, mult_t * C)
    np.testing.assert_allclose(got, want, **TOL)
    # the padding graph (last row) holds many padding nodes
    assert int(pb.n_node[-1]) > 1 and np.abs(want[-1]).max() > 0
