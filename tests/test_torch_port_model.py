"""The port's flagship Architecture against the JAX package's: weights
carried over by ``convert.state_dict_from_jax``, the same padded batch,
per-step node activations and the output at the tolerance of
tests/test_torch_twin.py (rtol 1e-5, atol 2e-5); strict conversion; and
initialisation bounds equal to the JAX initializers'."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import model as jax_model
from glam_tpu_torch import convert
from glam_tpu_torch.chem.featurize import smiles_to_arrays
from glam_tpu_torch.data.batching import GraphLoader
from glam_tpu_torch.data.graph import GraphArrays
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.nn.activations import Activation
from glam_tpu_torch.nn.init import init_bounds


def _cfg(cls, act="CELU", **kw):
    base = dict(mol_block="_TripletMessage", mol_readout="GlobalPool5",
                hid_dim_alpha=2, e_dim=48, message_steps=3, max_nodes=32,
                pre_act=act, graph_act=act, flat_act=act)
    base.update(kw)
    return cls(**base)


def _port_batch(smis):
    gs = []
    for s in smis:
        x, snd, rcv, e = smiles_to_arrays(s)
        gs.append(GraphArrays(nodes=x, edges=e, senders=snd, receivers=rcv,
                              y=np.ones(1, np.float32), smi=s))
    return next(iter(GraphLoader(gs, batch_size=len(gs), num_tasks=1)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def batches(request):
    sample_graphs = request.getfixturevalue("sample_graphs")
    jb = next(iter(JaxLoader(sample_graphs, batch_size=6, num_tasks=1)))
    return jb, _port_batch(SMILES_SET)


class TestForwardParity:
    @pytest.mark.parametrize("act", ["CELU", "RReLU", "ReLU"])
    def test_per_step_activations_and_output(self, batches, act):
        jb, pb = batches
        cfg_j = _cfg(jax_model.ModelConfig, act)
        model_j = jax_model.Architecture(cfg_j)
        params = model_j.init(jax.random.PRNGKey(3), jb, True)["params"]
        out_j, xs_j = model_j.apply({"params": params}, jb, True,
                                    return_nodes=True)
        cfg_t = _cfg(port_model.ModelConfig, act)
        model_t = port_model.Architecture(cfg_t)
        model_t.load_state_dict(
            convert.state_dict_from_jax(_np_tree(params), cfg_t))
        model_t.eval()
        with torch.no_grad():
            out_t, xs_t = model_t(pb, return_nodes=True)
        assert len(xs_j) == len(xs_t) == cfg_t.message_steps
        for step, (a, b) in enumerate(zip(xs_j, xs_t)):
            np.testing.assert_allclose(
                b.numpy(), np.asarray(a), rtol=1e-5, atol=2e-5,
                err_msg=f"node embeddings, message step {step}")
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=2e-5)

    def test_training_mode_rrelu_raises(self):
        """Training-mode RReLU raises without a generator; with one it
        draws a slope per element from U(1/8, 1/3), reproducibly."""
        act = Activation("RReLU")
        with pytest.raises(ValueError, match="Generator"):
            act(torch.ones(2))
        x = -torch.ones(20000)
        y = act(x, torch.Generator().manual_seed(0))
        assert ((-y >= 1 / 8) & (-y <= 1 / 3)).all()
        assert torch.equal(y, act(x, torch.Generator().manual_seed(0)))
        pos = torch.arange(1.0, 5.0)
        assert torch.equal(act(pos, torch.Generator()), pos)
        assert act.eval()(torch.tensor([-48.0])).item() == pytest.approx(
            -11.0)


@pytest.fixture(scope="module")
def jax_params(batches):
    jb, _ = batches
    cfg = _cfg(jax_model.ModelConfig)
    params = jax_model.Architecture(cfg).init(jax.random.PRNGKey(0), jb,
                                              True)["params"]
    return _np_tree(params)


class TestConvert:
    def test_round_trip_layouts(self, jax_params):
        sd = convert.state_dict_from_jax(jax_params,
                                         _cfg(port_model.ModelConfig))
        mol = jax_params["mol"]
        np.testing.assert_array_equal(
            sd["mol.lin0.linear.weight"].numpy(),
            mol["lin0"]["linear"]["kernel"].T)
        np.testing.assert_array_equal(
            sd["mol.conv.gru.weight_hh"].numpy(), mol["conv"]["gru"]["w_hh"].T)
        np.testing.assert_array_equal(
            sd["mol.conv.conv.weight_node"].numpy(),
            mol["conv"]["TripletMessage_0"]["weight_node"])

    @pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
    def test_strict(self, jax_params, fault):
        import copy
        tree = copy.deepcopy(jax_params)
        conv = tree["mol"]["conv"]["TripletMessage_0"]
        if fault == "missing":
            del conv["weight_scale"]
        elif fault == "extra":
            conv["weight_extra"] = np.zeros(3, np.float32)
        else:
            conv["bias"] = np.zeros(7, np.float32)
        with pytest.raises((KeyError, ValueError)):
            convert.state_dict_from_jax(tree, _cfg(port_model.ModelConfig))


class TestInit:
    def test_bounds_equal_jax_initializers(self, batches, monkeypatch):
        """Every JAX initializer here draws U(-b, b) through
        jax.random.uniform; recording b in place of a draw gives a tree of
        bounds, which convert maps onto the port's parameter names."""
        jb, _ = batches

        def fake_uniform(key, shape, dtype=jnp.float32, minval=0.0,
                         maxval=1.0):
            assert float(minval) == -float(maxval)
            return jnp.full(shape, maxval, dtype)

        monkeypatch.setattr(jax.random, "uniform", fake_uniform)
        cfg_j = _cfg(jax_model.ModelConfig, e_dim=1024, hid_dim_alpha=4)
        tree = jax_model.Architecture(cfg_j).init(
            jax.random.PRNGKey(0), jb, True)["params"]
        cfg_t = _cfg(port_model.ModelConfig, e_dim=1024, hid_dim_alpha=4)
        want = convert.state_dict_from_jax(_np_tree(tree), cfg_t)
        model = port_model.Architecture(
            cfg_t, torch.Generator().manual_seed(7))
        bounds = init_bounds(model)
        assert set(bounds) == set(want)
        for name, p in model.named_parameters():
            b = float(want[name].flatten()[0])
            assert (want[name] == b).all(), name
            assert bounds[name] == pytest.approx(b, rel=1e-6), name
            assert p.abs().max().item() <= b + 1e-7, name
            if p.numel() >= 100:   # drawn across the whole range
                assert p.abs().max().item() > 0.9 * b, name

    def test_seeded(self):
        cfg = _cfg(port_model.ModelConfig)
        a = port_model.Architecture(cfg, torch.Generator().manual_seed(1))
        b = port_model.Architecture(cfg, torch.Generator().manual_seed(1))
        c = port_model.Architecture(cfg, torch.Generator().manual_seed(2))
        sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not torch.equal(sa["mol.flat.linear.weight"],
                               sc["mol.flat.linear.weight"])


class TestConfig:
    def test_model_config_is_a_copy(self):
        fj = [(f.name, f.default) for f in
              dataclasses.fields(jax_model.ModelConfig)]
        ft = [(f.name, f.default) for f in
              dataclasses.fields(port_model.ModelConfig)]
        assert fj == ft
        args = {"e_dim": 64, "graph_res": 0, "lr": 1e-3, "batch_size": 8,
                "mol_block": "_TripletMessage", "bogus": 1}
        assert dataclasses.asdict(
            port_model.model_config_from_args(args, out_dim=2)) == \
            dataclasses.asdict(jax_model.model_config_from_args(
                args, out_dim=2))

    @pytest.mark.parametrize("field,name", [
        ("mol_block", "_NNConv"), ("mol_block", "_GATConv"),
        ("graph_norm", "_BatchNorm"), ("pre_norm", "_LayerNorm"),
        ("mol_readout", "Set2Set"), ("mol_readout", "GlobalLAPool")])
    def test_library_names_match_jax(self, batches, field, name):
        """Each name of the JAX layer library builds in the port and the
        eval-mode forward matches the JAX package's."""
        jb, pb = batches
        model_j = jax_model.Architecture(_cfg(jax_model.ModelConfig,
                                              **{field: name}))
        variables = model_j.init(jax.random.PRNGKey(6), jb, True)
        cfg_t = _cfg(port_model.ModelConfig, **{field: name})
        model_t = port_model.Architecture(cfg_t)
        model_t.load_state_dict(convert.state_dict_from_jax(
            _np_tree(variables["params"]), cfg_t,
            _np_tree(variables.get("batch_stats", {}))))
        model_t.eval()
        with torch.no_grad():
            got = model_t(pb).numpy()
        np.testing.assert_allclose(got, np.asarray(model_j.apply(
            variables, jb, True)), rtol=1e-5, atol=2e-5)
