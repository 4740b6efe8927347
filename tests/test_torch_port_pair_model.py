"""The pair model of the port against the JAX package, on the CPU.

  * fusion (``dot_and_global_pool``), ``stats5`` False and True, with an
    empty graph on each side, the padding slot (nodes past ``max_nodes``
    dropped) and deliberately tied maxima: outputs and input gradients at
    rtol 1e-5 / atol 1e-5 (float32 products summed in other orders);
  * ``PairArchitecture`` with weights carried over by
    ``convert.state_dict_from_jax(pair=...)``, eval mode, on the same
    padded pair batches of the bundled corpora: homo with
    ``_TripletMessage`` towers, hetero with a ``_TripletMessage`` molecule
    tower and each of ``_NNConv``, ``_GCNConv`` and ``_GATConv`` as the
    protein tower; outputs at atol 1e-4, the whole parameter-gradient
    tree at rtol 5e-4 / atol 1e-6, the flagship's gradient-tree
    tolerance (tests/test_torch_port_backward.py), its atol taken in
    units of each tensor's largest entry where that exceeds 1: these
    gradients reach ~17, where one float32 ulp is 1.9e-6, and near-zero
    entries of such a tensor differ by a few ulps of it (both packages'
    float32 gradients lie within ~1.4e-6 of that scale of a float64
    torch run);
  * strict conversion of a pair tree (missing, extra, misshapen leaf).
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glam_tpu.data import batching as jax_batching
from glam_tpu.data import pair_datasets as jax_pairs
from glam_tpu.nn import fusion as jax_fusion
from glam_tpu.nn import model as jax_model
from glam_tpu_torch import convert
from glam_tpu_torch.data import batching as port_batching
from glam_tpu_torch.nn import fusion as port_fusion
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.train.pair_trainer import _set_pair_max_nodes
from test_torch_port_model import _np_tree

DATA = Path(__file__).resolve().parents[1] / "datasets"


# ------------------------------------------------------------------ fusion
def _side(rng, counts, pad, C):
    """Flat node arrays of graphs with ``counts`` nodes and ``pad``
    padding nodes (the last graph slot)."""
    sizes = list(counts) + [pad]
    graph = np.repeat(np.arange(len(sizes)), sizes)
    pos = np.concatenate([np.arange(n) for n in sizes])
    x = rng.randn(graph.size, C).astype(np.float32)
    return x, graph, pos, np.asarray(sizes)


def _fusion_inputs(seed=0, C=6):
    rng = np.random.RandomState(seed)
    xm, mg, mp, mc = _side(rng, [3, 0, 4, 2], 6, C)       # max_m 4
    xp, pg, pp, pc = _side(rng, [2, 3, 0, 5], 3, C)       # max_p 5
    # graph 0: two equal molecule rows against positive protein rows, so
    # the maximum is tied (and the median's sort meets ties)
    xm[1] = xm[0] = np.abs(xm[0]) * 3
    xp[:2] = np.abs(xp[:2])
    # graph 3: an equal pair of protein rows
    xp[7] = xp[6]
    return (xm, mg, mp, mc, xp, pg, pp, pc), 4, 5


@pytest.mark.parametrize("stats5", [False, True])
def test_fusion_forward_and_gradient(stats5):
    (xm, mg, mp, mc, xp, pg, pp, pc), max_m, max_p = _fusion_inputs()
    G = mc.size
    w = np.random.RandomState(1).randn(G, 5 if stats5 else 2).astype(
        np.float32)

    def jax_obj(a, b):
        out = jax_fusion.dot_and_global_pool(
            a, b, jnp.asarray(mg), jnp.asarray(mp), jnp.asarray(mc),
            jnp.asarray(pg), jnp.asarray(pp), jnp.asarray(pc), G, max_m,
            max_p, stats5)
        return jnp.sum(out * w), out

    (_, want), (gm_j, gp_j) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(jnp.asarray(xm),
                                                jnp.asarray(xp))
    tm = torch.tensor(xm, requires_grad=True)
    tp = torch.tensor(xp, requires_grad=True)
    t = torch.from_numpy
    got = port_fusion.dot_and_global_pool(
        tm, tp, t(mg), t(mp), t(mc), t(pg), t(pp), t(pc), G, max_m, max_p,
        stats5)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert (got[1] == 0).all() and (got[2] == 0).all()   # empty graphs
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(gm_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp_j), rtol=1e-5,
                               atol=1e-5)
    if not stats5:
        # the tied maximum's gradient is split evenly over its two rows
        # (the median's stable sort picks one of them)
        assert torch.equal(tm.grad[0], tm.grad[1])
    # padding nodes past max_nodes get no gradient
    assert (tm.grad[mp >= max_m] == 0).all()


# --------------------------------------------------------- pair model
def _pair_data(which):
    if which == "homo":
        import pandas as pd
        df = pd.read_csv(DATA / "ddi_demo" / "raw" / "drugbank_caster.csv")
        from glam_tpu.chem.featurize import smiles_to_arrays
        from glam_tpu.data.graph import GraphArrays

        def g(s, y=0.0):
            x, snd, rcv, e = smiles_to_arrays(s)
            return GraphArrays(x, e, snd, rcv, np.asarray([y], np.float32),
                               s)
        rows = df.iloc[::37][:12]
        return [(g(a, y), g(b)) for a, b, y in zip(
            rows.Drug1_SMILES, rows.Drug2_SMILES, rows.label)]
    ds = jax_pairs.BindingDBDataset(str(DATA / "dti_demo"))
    return ds.train[::29][:12]


def _models(which, pro_block, seed):
    pairs = _pair_data(which)
    hetero = which == "hetero"
    kw = dict(mol_block="_TripletMessage", pro_block=pro_block,
              hid_dim_alpha=2, e_dim=32, message_steps=2,
              graph_norm="_PairNorm", out_dim=1 if not hetero else 2)
    _set_pair_max_nodes(kw, pairs, hetero=hetero)
    cfg_j = jax_model.ModelConfig(**kw)
    cfg_t = port_model.ModelConfig(**kw)
    jb = next(iter(jax_batching.PairGraphLoader(pairs, 12, 1)))
    pb = next(iter(port_batching.PairGraphLoader(pairs, 12, 1)))
    model_j = jax_model.PairArchitecture(cfg_j, hetero=hetero)
    params = jax.jit(lambda r, *b: model_j.init(r, *b, True))(
        jax.random.PRNGKey(seed), *jb)["params"]
    model_t = port_model.PairArchitecture(cfg_t, hetero=hetero)
    model_t.load_state_dict(convert.state_dict_from_jax(
        _np_tree(params), cfg_t, pair=which))
    return model_j, params, model_t, cfg_t, jb, pb


CASES = [("homo", "_GCNConv"), ("hetero", "_NNConv"),
         ("hetero", "_GCNConv"), ("hetero", "_GATConv")]


@pytest.mark.parametrize("which,pro_block", CASES)
def test_pair_architecture_matches_jax(which, pro_block):
    model_j, params, model_t, cfg_t, jb, pb = _models(which, pro_block, 3)
    w = np.random.RandomState(2).randn(jb[0].n_node.shape[0],
                                       cfg_t.out_dim).astype(np.float32)
    mask = np.asarray(jb[0].graph_mask, np.float32)[:, None]

    def objective(p):
        out = model_j.apply({"params": p}, *jb, True)
        return jnp.sum(out * w * mask), out

    (_, out_j), grads = jax.jit(jax.value_and_grad(objective,
                                                   has_aux=True))(params)
    model_t.eval()
    out_t = model_t(*pb)
    ((out_t * torch.from_numpy(w * mask)).sum()).backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-4)
    grads_j = convert.state_dict_from_jax(_np_tree(grads), cfg_t,
                                          pair=which)
    named = dict(model_t.named_parameters())
    assert set(named) == set(grads_j)
    assert any(k.startswith("mol2.conv.conv") for k in named)
    for name, want in grads_j.items():
        got = named[name].grad
        assert got is not None, name
        scale = max(float(want.abs().max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.fixture(scope="module")
def gat_model():
    _, params, _, cfg_t, _, _ = _models("hetero", "_GATConv", 0)
    return _np_tree(params), cfg_t


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_pair_convert_strict(gat_model, fault):
    params, cfg_t = gat_model
    tree = copy.deepcopy(params)
    if fault == "missing":
        del tree["lin_out0"]
    elif fault == "extra":
        tree["mol2"]["spare"] = np.zeros(3, np.float32)
    else:
        tree["lin_out1"]["linear"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises((KeyError, ValueError)):
        convert.state_dict_from_jax(tree, cfg_t, pair="hetero")
    with pytest.raises(ValueError, match="pair"):
        convert.state_dict_from_jax(params, cfg_t, pair="twin")
