"""The graph partition (``glam_tpu_torch/parallel/graph_partition.py``)
against the JAX package, on the CPU.

  * the host plans (``partition_graphs``, ``split_large_graph``,
    ``build_halo_exchange``, ``build_halo_exchange_ring``) equal the JAX
    package's exactly, at 2 and 4 shards, with and without budget floors;
  * the v1 (all_gather) and v2 (all_to_all) halo message steps on 2 gloo
    ranks (one spawn of ``tests/torch_port_dp_worker.py``), on a graph
    with empty rows and edges across the shard boundary, equal the port's
    ``reference_halo_step`` and the JAX package's within 1e-5 (float32
    sums in other orders; the steps' softmax and sum is kernel C's plain
    version here).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET, graphs_from_smiles
from glam_tpu.parallel import graph_partition as jgp
from glam_tpu_torch.data.graph import GraphArrays
from glam_tpu_torch.parallel import graph_partition as gp
from test_torch_port_dp import FIELDS
from torch_port_dp_worker import spawn_ranks, wait_ranks


def contact_graph(L=120, band=4, n_long=10, seed=0, fe=8, fn=12):
    """A contact-map-like graph: backbone, banded contacts, long-range
    contacts (across shards), and 10 nodes with no incoming edge."""
    rng = np.random.RandomState(seed)
    snd, rcv = [], []
    for i in range(L - 1):
        snd += [i, i + 1]
        rcv += [i + 1, i]
    for i in range(L):
        for j in range(i + 2, min(L, i + band + 1)):
            snd += [i, j]
            rcv += [j, i]
    for _ in range(n_long):
        i, j = rng.randint(0, L, 2)
        snd += [i, j]
        rcv += [j, i]
    snd, rcv = np.asarray(snd, np.int32), np.asarray(rcv, np.int32)
    keep = ~np.isin(rcv, np.arange(30, 40))         # rows 30-39 empty
    snd, rcv = snd[keep], rcv[keep]
    return (rng.randn(L, fn).astype(np.float32),
            rng.randn(len(snd), fe).astype(np.float32), snd, rcv)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_partition_graphs_equals_jax(n_parts):
    gs = graphs_from_smiles(SMILES_SET * 2,
                            ys=np.arange(12, dtype=np.float32))
    want = jgp.partition_graphs(gs, n_parts)
    got = gp.partition_graphs([GraphArrays(*g) for g in gs], n_parts)
    assert len(got) == n_parts
    for k, part in enumerate(got):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(part, f).numpy(),
                                          np.asarray(getattr(want, f))[k],
                                          err_msg=f)


@pytest.mark.parametrize("n_parts,budgets", [(2, (0, 0, 0)), (4, (0, 0, 0)),
                                             (2, (300, 900, 40))])
def test_host_plans_equal_jax(n_parts, budgets):
    nodes, edges, snd, rcv = contact_graph()
    node_budget, edge_budget, halo_budget = budgets
    want = jgp.split_large_graph(nodes, edges, snd, rcv, n_parts,
                                 node_budget, edge_budget)
    got = gp.split_large_graph(nodes, edges, snd, rcv, n_parts,
                               node_budget, edge_budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sg, emask, n_local = got[2], got[4], got[0].shape[1]
    for a, b in zip(gp.build_halo_exchange(sg, emask, n_local, halo_budget),
                    jgp.build_halo_exchange(sg, emask, n_local,
                                            halo_budget)):
        np.testing.assert_array_equal(a, b)
    got_r = gp.build_halo_exchange_ring(sg, emask, n_local)
    want_r = jgp.build_halo_exchange_ring(sg, emask, n_local)
    assert got_r[1] == want_r[1]
    for a, b in zip(got_r[0], want_r[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_r[2], want_r[2])
    floors = tuple(b + 8 for b in want_r[1])
    for a, b in zip(gp.build_halo_exchange_ring(sg, emask, n_local, floors),
                    jgp.build_halo_exchange_ring(sg, emask, n_local,
                                                 floors)):
        if isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(a, b)


def _halo_inputs(n_parts=2, C=16):
    nodes, edges, snd, rcv = contact_graph()
    ns, es, sg, rl, emask = gp.split_large_graph(nodes, edges, snd, rcv,
                                                 n_parts)
    send_idx, _, snd_l, H = gp.build_halo_exchange(sg, emask, ns.shape[1])
    w_in = np.random.RandomState(1).randn(nodes.shape[1], C).astype(
        np.float32) * 0.3
    params = gp.init_halo_params(torch.Generator().manual_seed(0), C,
                                 edges.shape[1])
    t = torch.from_numpy
    shards = {"nodes": t(ns @ w_in), "edges": t(es),
              "senders_global": t(sg), "receivers": t(rl),
              "edge_mask": t(emask), "senders_local": t(snd_l),
              "send_idx": t(send_idx)}
    return params, shards, (nodes @ w_in, edges, snd, rcv)


@pytest.fixture(scope="module")
def halo_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("halo")
    params, shards, whole = _halo_inputs()
    torch.save(dict(shards, params=params), work / "halo.pt")
    (work / "plan.json").write_text(json.dumps({"tasks": ["halo"],
                                                "platform": "cpu"}))
    got = wait_ranks(spawn_ranks(work, "cpu"), work)["halo"]
    return got, params, whole


def test_halo_steps_match_both_references(halo_run):
    got, params, (nodes, edges, snd, rcv) = halo_run
    N = nodes.shape[0]
    port_ref = gp.reference_halo_step(params, torch.from_numpy(nodes),
                                      torch.from_numpy(edges),
                                      torch.from_numpy(snd),
                                      torch.from_numpy(rcv))
    jax_ref = np.asarray(jgp.reference_halo_step(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(nodes), jnp.asarray(edges), jnp.asarray(snd),
        jnp.asarray(rcv)))
    np.testing.assert_allclose(port_ref.numpy(), jax_ref, rtol=1e-5,
                               atol=1e-5)
    assert np.abs(jax_ref[30:40]).max() == 0             # empty rows
    for name in ("v1", "v2"):
        out = got[name].reshape(-1, got[name].shape[-1])[:N].numpy()
        np.testing.assert_allclose(out, jax_ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(out, port_ref.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_halo_bytes():
    assert gp.halo_bytes(64, 8, 60, 2) == (64 * 60 * 4, 8 * 60 * 4)


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_halo_step_gradients_match_the_reference(halo_run, name):
    """Each rank's backward through the collectives gives the whole
    parameter gradient and its shard's node gradient."""
    got, params, (nodes, edges, snd, rcv) = halo_run
    N, C = nodes.shape[0], params["weight_node"].shape[1]
    g = got["grads"][name]
    n_pad = g["nodes"].shape[0] * g["nodes"].shape[1]
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = torch.zeros(n_pad, nodes.shape[1])
    x[:N] = torch.from_numpy(nodes)
    x.requires_grad_()
    out = gp.reference_halo_step(p, x[:N], torch.from_numpy(edges),
                                 torch.from_numpy(snd),
                                 torch.from_numpy(rcv))
    w = torch.randn(n_pad, C, generator=torch.Generator().manual_seed(3))
    (out * w[:N]).sum().backward()
    for k in params:
        torch.testing.assert_close(g["params"][k], p[k].grad, rtol=1e-4,
                                   atol=1e-5, msg=k)
    torch.testing.assert_close(g["nodes"].reshape(n_pad, -1), x.grad,
                               rtol=1e-4, atol=1e-5)
