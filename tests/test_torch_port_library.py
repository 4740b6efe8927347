"""The whole single-graph model against the JAX package with every conv x
readout of the layer library, weights and BatchNorm statistics carried
over by ``convert.state_dict_from_jax``, on one padded batch:

  * 'bn': pre, graph, flat and end norms all ``_BatchNorm``, in training
    mode (batch statistics; the graph norm is called by the 3 weight-tied
    message steps, so its running statistics move 3 times per forward)
    and then in eval mode with the updated running statistics;
  * 'ln': ``_GraphSizeNorm`` before, ``_LayerNorm`` in the message steps
    and on the flat and end blocks.

No dropout and CELU activations, so neither side draws noise.  Outputs
at rtol 1e-5 / atol 2e-5 on every row, the padding graph's included;
running statistics at rtol 1e-5 / atol 2e-5 relative to their scale;
the parameter-gradient tree of a training step at rtol 5e-4 / atol 1e-6,
as tests/test_torch_port_backward.py."""
import jax
import numpy as np
import pytest

from conftest import SMILES_SET
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import model as jax_model
from glam_tpu.train.trainer import make_loss_fn as jax_loss_fn
from glam_tpu_torch import convert
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.train.trainer import make_loss_fn as port_loss_fn
from test_torch_port_model import _cfg, _np_tree, _port_batch

NORMS = {
    "bn": dict(pre_norm="_BatchNorm", graph_norm="_BatchNorm",
               flat_norm="_BatchNorm", end_norm="_BatchNorm"),
    "ln": dict(pre_norm="_GraphSizeNorm", graph_norm="_LayerNorm",
               flat_norm="_LayerNorm", end_norm="_LayerNorm"),
}
CONVS = ["_TripletMessage", "_TripletMessageLight", "_NNConv", "_GCNConv",
         "_GATConv"]
READOUTS = ["GlobalPool5", "GlobalLAPool", "Set2Set"]


@pytest.fixture(scope="module")
def batches(request):
    sample_graphs = request.getfixturevalue("sample_graphs")
    return (next(iter(JaxLoader(sample_graphs, batch_size=6, num_tasks=1))),
            _port_batch(SMILES_SET))


def _models(jb, block, readout, norms, seed=1):
    kw = dict(mol_block=block, mol_readout=readout, graph_do="_None()",
              end_do="_None()", **NORMS[norms])
    model_j = jax_model.Architecture(_cfg(jax_model.ModelConfig, **kw))
    variables = model_j.init(jax.random.PRNGKey(seed), jb, True)
    cfg_t = _cfg(port_model.ModelConfig, **kw)
    model_t = port_model.Architecture(cfg_t)
    model_t.load_state_dict(convert.state_dict_from_jax(
        _np_tree(variables["params"]), cfg_t,
        _np_tree(variables.get("batch_stats", {}))))
    return model_j, variables, model_t, cfg_t


@pytest.mark.parametrize("norms", ["bn", "ln"])
@pytest.mark.parametrize("readout", READOUTS)
@pytest.mark.parametrize("block", CONVS)
def test_model_matches_jax(batches, block, readout, norms):
    jb, pb = batches
    model_j, variables, model_t, cfg_t = _models(jb, block, readout, norms)
    out_j, upd = model_j.apply(variables, jb, False,
                               mutable=["batch_stats"])
    model_t.train()
    out_t = model_t(pb)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=2e-5)
    if norms == "ln":
        return
    want = convert.state_dict_from_jax(
        _np_tree(variables["params"]), cfg_t,
        _np_tree(upd["batch_stats"]))
    got = model_t.state_dict()
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert len(stats) == 8            # 4 BatchNorms x (mean, var)
    for k in stats:
        scale = max(float(want[k].abs().max()), 1.0)
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=2e-5 * scale, err_msg=k)
    out_j = model_j.apply({"params": variables["params"],
                           "batch_stats": upd["batch_stats"]}, jb, True)
    model_t.eval()
    np.testing.assert_allclose(model_t(pb).detach().numpy(),
                               np.asarray(out_j), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("block,readout,norms", [
    ("_TripletMessageLight", "Set2Set", "bn"),
    ("_GATConv", "GlobalLAPool", "ln"),
    ("_NNConv", "GlobalPool5", "ln"),
    ("_GCNConv", "Set2Set", "bn")])
def test_gradient_tree_matches_jax(batches, block, readout, norms):
    """The whole parameter-gradient tree of a training-mode step against
    jax.grad with converted weights."""
    jb, pb = batches
    model_j, variables, model_t, cfg_t = _models(jb, block, readout, norms,
                                                 seed=4)
    loss_j = jax_loss_fn("regression", "mse", 1)
    stats = variables.get("batch_stats", {})

    def objective(p):
        out, _ = model_j.apply({"params": p, "batch_stats": stats}, jb,
                               False, mutable=["batch_stats"])
        return loss_j(out, jb.y, jb.graph_mask)

    grads_j = convert.state_dict_from_jax(
        _np_tree(jax.grad(objective)(variables["params"])), cfg_t)
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
