"""The predictors' captured forwards (``cuda_graphs.ForwardGraphs``): one
CUDA graph per batch signature, the counterpart of the JAX predictors'
jitted executables (``glam_tpu/serve.py``).

On the CPU, against the JAX package (its predictors run as
``tests/test_torch_port_serve.py`` runs them, on JAX-written ``.ckpt``
checkpoints that the port serves through ``convert.load_jax_checkpoint``),
with the predictors' graphs stood in by a recorder:
  * every batch of a request at the pinned budgets, the short last one
    included, has one signature, which the predictor pins; a fallback
    request (``max_nodes=8``) has another, unpinned; the JAX predictor
    compiles as many executables as the port sees signatures;
  * over three ``PairPredictor.predict_pairs`` calls whose inputs grow,
    the port's floors equal the JAX predictor's ``_budget1/_budget2``
    after each call, and the port frees its graphs (a new signature)
    exactly where JAX compiles a new executable.
Outputs within rtol 1e-5 + atol 2e-5 (``test_predictions_match``'s).

Marked ``cuda`` (skipped without a card): replayed outputs equal the
same predictor's eager forward bitwise (flagship, Set2Set + BatchNorm,
GAT + LAPool, DDI, DTI), launches are counted at replay, three floor
growths leave ``torch.cuda.memory_reserved`` within one pool of where it
started, a fallback request is served with the cache bounded, and every
ticket buffer is zero afterwards.  The JAX package is imported inside
the CPU tests alone, which skip where a card is present (the card's
machine has no JAX), so that the card's tests also run there:

    python -m pytest --noconftest tests/test_torch_port_serve_graphs.py

Also on the CPU: a ticket buffer grown for a larger batch keeps its
predecessor alive, since a graph captured before the growth replays over
it (``ops/kernels/common.py``).
"""
import dataclasses
import importlib.util
import json

import numpy as np
import pytest
import torch

from glam_tpu_torch.cuda_graphs import signature
from glam_tpu_torch.serve import PairPredictor, Predictor

SMALL = dict(mol_block="_TripletMessage", hid_dim_alpha=2, e_dim=32,
             message_steps=2)
ASPIRIN, CAFFEINE = "CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C"
TRICYCLIC = "Clc1cc2c(Oc3ccccc3C3CN(CC32)C)cc1"
# three requests whose inputs grow: tower 1's floors, then tower 2's
PAIR_REQUESTS = [
    [("CCO", "C"), ("c1ccccc1", "CCO"), ("xyz", "CCO")],
    [("CCO", "C"), (ASPIRIN, "CCO"), (TRICYCLIC, "C"), ("C", "CCO"),
     ("CCN(CC)CC", "CC")],
    [("CCO", CAFFEINE), ("C", TRICYCLIC), ("CC", "O=C(O)c1ccccc1O")],
]


class _Recorder:
    """Stands in for a predictor's ``ForwardGraphs`` on the CPU: runs
    the model eagerly and records each batch's signature and pin flag,
    and each release."""

    def __init__(self, model):
        self.model = model
        self.calls, self.releases = [], 0

    def __call__(self, parts, pin=False):
        self.calls.append((signature(parts), pin))
        return self.model(*parts)

    def release(self):
        self.releases += 1


@pytest.fixture
def sample_graphs():
    """The JAX package's graphs of conftest's SMILES.  The JAX predictors
    are the reference on the CPU alone: with a card present (the card's
    machine has no JAX) the test skips."""
    if torch.cuda.is_available() or importlib.util.find_spec("jax") is None:
        pytest.skip("the JAX predictors are the reference on the CPU only")
    from conftest import SMILES_SET, graphs_from_smiles
    return graphs_from_smiles(SMILES_SET)


def _jit_cache_size(fn) -> int:
    """Executables JAX compiled for a jitted function, or for the one a
    lambda closes over (``PairPredictor._forward``)."""
    if not hasattr(fn, "_cache_size"):
        fn = next(c.cell_contents for c in fn.__closure__
                  if hasattr(c.cell_contents, "_cache_size"))
    return fn._cache_size()


@pytest.mark.parametrize("max_nodes", [32, 8])
def test_request_batches_share_one_signature(tmp_path, sample_graphs,
                                             max_nodes):
    from glam_tpu.serve import Predictor as JaxPredictor
    from test_torch_port_serve import REQUEST
    _write_jax_ckpt(tmp_path, sample_graphs, {
        "dataset": "demo", "task": "binary_nan_bce", "num_tasks": 1,
        "out_dim": 1}, dict(SMALL, max_nodes=max_nodes), pair=False)
    pj = JaxPredictor.from_checkpoint(tmp_path, batch_size=4)
    pt = Predictor.from_checkpoint(tmp_path, which="best_save.ckpt",
                                   batch_size=4, device="cpu")
    assert pt.graphs is None and pt.graph_stats is None   # CPU: eager
    pt.graphs = rec = _Recorder(pt.model)
    want, got = pj.predict_smiles(REQUEST), pt.predict_smiles(REQUEST)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    valid = [g for g in pt.featurize(REQUEST) if g is not None]
    batches = pt.batches(valid)
    assert len(rec.calls) == len(batches) == 3
    assert int(batches[-1].graph_mask.sum()) < 4          # the short last
    sigs = {sig for sig, _ in rec.calls}
    assert len(sigs) == 1 == _jit_cache_size(pj._forward)
    pinned = max_nodes == 32
    assert [pin for _, pin in rec.calls] == [pinned] * 3
    assert ((batches[0].num_nodes, batches[0].num_edges)
            == (pt.node_budget, pt.edge_budget)) == pinned
    assert rec.releases == 0


def _write_jax_ckpt(run_dir, sample_graphs, args, model_kw, pair):
    """A JAX checkpoint from init params, as the JAX trainer writes
    ``best_save.ckpt``: of the single-graph model, or of the DDI model
    (two towers) if ``pair``."""
    import jax
    from flax import serialization
    from glam_tpu.data.batching import GraphLoader as JaxLoader
    from glam_tpu.nn import model as jax_model
    cfg = jax_model.ModelConfig(**model_kw)
    args = dict(args, model_cfg=dataclasses.asdict(cfg))
    batch = next(iter(JaxLoader(sample_graphs[:2], 2, 1)))
    if pair:
        model = jax_model.PairArchitecture(cfg, hetero=False)
        init = jax.jit(lambda k, b: model.init(k, b, b, True))
    else:
        model = jax_model.Architecture(cfg)
        init = jax.jit(lambda k, b: model.init(k, b, True))
    variables = init(jax.random.PRNGKey(7), batch)
    payload = {"args": json.dumps(args), "records": json.dumps({}),
               "params": serialization.to_bytes(variables["params"]),
               "batch_stats": serialization.to_bytes(
                   variables.get("batch_stats", {}))}
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "best_save.ckpt").write_bytes(
        serialization.msgpack_serialize(payload))


def test_pair_floors_recapture_where_jax_recompiles(tmp_path,
                                                    sample_graphs):
    from glam_tpu.serve import PairPredictor as JaxPairPredictor
    _write_jax_ckpt(tmp_path, sample_graphs, {
        "dataset": "drugbank_caster", "task": "pair_binary_bce",
        "num_tasks": 1, "out_dim": 1}, dict(
            SMALL, max_nodes=32, hid_dim_alpha=1, e_dim=16,
            message_steps=1), pair=True)
    jp = JaxPairPredictor.from_checkpoint(tmp_path, batch_size=4)
    pt = PairPredictor.from_checkpoint(tmp_path, which="best_save.ckpt",
                                       batch_size=4, device="cpu")
    assert pt.graphs is None
    pt.graphs = rec = _Recorder(pt.model)
    floors, seen = [], []
    for pairs in PAIR_REQUESTS:
        want, got = jp.predict_pairs(pairs), pt.predict_pairs(pairs)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
        assert (pt.budget1, pt.budget2) == (jp._budget1, jp._budget2)
        floors.append((pt.budget1, pt.budget2))
        sigs = {sig for sig, _ in rec.calls[len(seen):]}
        assert len(sigs) == 1                   # one signature a request
        seen += [sig for sig, _ in rec.calls[len(seen):]]
        # a new signature exactly where JAX compiles a new executable
        assert len(set(seen)) == _jit_cache_size(jp._forward)
    assert floors[0][0] < floors[1][0] and floors[1][1] < floors[2][1]
    assert len(set(floors)) == 3 == len(set(seen))
    # each new pair of floors (the first request's too) frees the graphs
    # of the floors before it
    assert rec.releases == 3
    assert not any(pin for _, pin in rec.calls)


def test_a_grown_ticket_buffer_outlives_the_graphs_over_it(monkeypatch):
    """A graph captured before a ticket buffer grows still replays over
    the old one, so growing keeps it (zeroed, and read by
    ``dirty_tickets``) rather than freeing it.  CPU buffers under a stream
    key no card has, outside any capture."""
    from glam_tpu_torch.ops.kernels import common
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    key, dev = (None, -12345), torch.device("cpu")
    try:
        small = common.tickets(dev, key[1], 10)
        assert common.tickets(dev, key[1], 1024) is small
        big = common.tickets(dev, key[1], 5000)
        assert big.numel() == 5000 and not big.any()
        assert any(b is small for k, b in common._RETIRED if k == key)
        small[3] = 7
        assert common.dirty_tickets()[key] == {3: 7}
        small.zero_()
        assert key not in common.dirty_tickets()
    finally:
        common._TICKETS.pop(key, None)
        common._RETIRED[:] = [(k, b) for k, b in common._RETIRED if k != key]


# ----------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tickets_zero():
    from glam_tpu_torch.ops.kernels import common
    torch.cuda.synchronize()
    assert common.dirty_tickets() == {}


def _predictor(cuda, batch_size=8, max_nodes=64, **kw):
    from glam_tpu_torch.nn.model import Architecture, ModelConfig
    cfg = ModelConfig(**dict(SMALL, max_nodes=max_nodes, **kw))
    model = Architecture(cfg, torch.Generator().manual_seed(0))
    args = {"task": "binary_nan_bce", "num_tasks": 1, "out_dim": 1,
            "model_cfg": dataclasses.asdict(cfg)}
    return Predictor(model, args, batch_size, device=cuda)


def _pair_predictor(cuda, hetero, batch_size=4):
    from chip_smoke import synthetic_protein
    from glam_tpu_torch.nn.model import ModelConfig, PairArchitecture
    kw = dict(pro_block="_GATConv", out_dim=2) if hetero else {}
    cfg = ModelConfig(**dict(SMALL, **kw))
    model = PairArchitecture(cfg, hetero=hetero,
                             generator=torch.Generator().manual_seed(0))
    args = {"task": "pair_binary" if hetero else "pair_binary_bce",
            "out_dim": cfg.out_dim}
    maps = dict(synthetic_protein(seed=s, length=40 * (s + 1))
                for s in range(3)) if hetero else None
    return PairPredictor(model, args, maps, batch_size, device=cuda)


def _eager(pred, items):
    """The predictor's model on each loader item, eagerly on the card,
    the valid rows of each batch stacked."""
    outs = []
    with torch.inference_mode():
        for parts in items:
            out = pred.model(*(p.to(pred.device) for p in parts)).cpu()
            outs.append(out.numpy()[parts[0].graph_mask.numpy()])
    return np.concatenate(outs)


DEMO = ["CCO", "c1ccccc1", ASPIRIN, CAFFEINE, TRICYCLIC, "C",
        "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C(O)c1ccccc1O", "CCN(CC)CC",
        "CCCCCCCC", "c1ccc2ccccc2c1", "OCC(O)CO"]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {}, dict(mol_block="_TripletMessageLight", mol_readout="Set2Set",
             graph_norm="_BatchNorm", flat_norm="_BatchNorm",
             end_norm="_LayerNorm"),
    dict(mol_block="_GATConv", mol_readout="GlobalLAPool",
         pre_norm="_LayerNorm")], ids=["flagship", "set2set_bn",
                                       "gat_lapool"])
def test_replays_equal_eager_bitwise(cuda, kw):
    pred = _predictor(cuda, batch_size=4, **kw)
    smis = DEMO * 2
    first = pred.predict_smiles(smis)         # warm-up, capture, replays
    again = pred.predict_smiles(smis)         # replays only
    st = pred.graph_stats
    assert st["captures"] == 1 and st["signatures"] == 1
    assert st["replays"] == 2 * len(pred.batches(
        [g for g in pred.featurize(smis) if g is not None])) - 1
    want = _eager(pred, [(b,) for b in pred.batches(
        [g for g in pred.featurize(smis) if g is not None])])
    np.testing.assert_array_equal(first, want)   # the warm-up batch too
    np.testing.assert_array_equal(again, want)
    _tickets_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("hetero", [False, True], ids=["ddi", "dti"])
def test_pair_replays_equal_eager_bitwise(cuda, hetero):
    pred = _pair_predictor(cuda, hetero)
    seq = next(iter(pred.contact_maps)) if hetero else None
    pairs = [(s, seq if hetero else t) for s, t in zip(DEMO, DEMO[::-1])]
    first = pred.predict_pairs(pairs)
    again = pred.predict_pairs(pairs)
    assert pred.graph_stats["captures"] == 1
    want = _eager(pred, list(pred.loader(
        [s for s in pred.samples(pairs) if s is not None])))
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(again, want)
    _tickets_zero()


@pytest.mark.cuda
def test_replays_count_their_launches(cuda):
    from glam_tpu_torch.ops.kernels import launch_counts
    pred = _predictor(cuda, batch_size=4)
    pred.predict_smiles(DEMO)                 # warm-up, capture, replays
    n = len(pred.batches([g for g in pred.featurize(DEMO)
                          if g is not None]))
    before = launch_counts()
    replays = pred.graph_stats["replays"]
    pred.predict_smiles(DEMO)
    after = launch_counts()
    assert pred.graph_stats["replays"] - replays == n
    assert after["triplet_fused_fwd"] - before["triplet_fused_fwd"] == 2 * n
    _tickets_zero()


@pytest.mark.cuda
def test_floor_growths_free_their_graphs(cuda):
    """The protein floors grow twice, then the molecule floors: each
    growth frees the graph before it, so the memory held (the cache's
    free blocks given back first) ends within one pool of the start."""
    pred = _pair_predictor(cuda, hetero=True)
    seqs = list(pred.contact_maps)             # 40, 80, 120 residues
    smis = DEMO[:8]
    pred.predict_pairs([(s, seqs[0]) for s in smis])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved(cuda)
    pools = []
    for pairs in ([(s, seqs[1]) for s in smis], [(s, seqs[2]) for s in smis],
                  [(s, seqs[2]) for s in smis + ["C" * 30]]):
        pred.predict_pairs(pairs)
        pools.append(pred.graph_stats["pool_bytes"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st = pred.graph_stats
    assert st["released"] == 3 and st["signatures"] == 1
    assert torch.cuda.memory_reserved(cuda) - start <= max(pools)
    _tickets_zero()


@pytest.mark.cuda
def test_fallback_requests_are_served_and_the_cache_is_bounded(cuda):
    pred = _predictor(cuda, batch_size=4, max_nodes=8)
    for k in range(5):                        # 3 fallback signatures
        smis = DEMO[k:] * 2
        got = pred.predict_smiles(smis)
        valid = [g for g in pred.featurize(smis) if g is not None]
        want = _eager(pred, [(b,) for b in pred.batches(valid)])
        np.testing.assert_array_equal(got[np.isfinite(got[:, 0])], want)
        assert len(pred.graphs) <= 2          # no pinned one was used
    assert pred.graph_stats["signatures"] <= 2
    _tickets_zero()
