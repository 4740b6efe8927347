"""The node-sharded tower (``glam_tpu_torch/parallel/sharded_model.py``)
against the port's dense models and the JAX package, on the CPU.

  * the host plans: ``shard_inputs`` equals the JAX package's exactly
    (a2a, ring, auto; with budget floors), and ``make_stochastic_inputs``
    lays its draws out as the JAX package's (shapes, padding slots) and
    draws the same global noise at any shard count;
  * one spawn of 2 gloo ranks (``tests/torch_port_dp_worker.py``, task
    ``sharded``) computes every case below; the file parametrises the
    comparisons over them:
      - the 5 convs x 3 readouts of a 120-node random graph: the sharded
        forward against the port's dense ``Architecture`` and the JAX
        package's dense model (rtol 1e-4, atol 1e-5), every parameter's
        gradient against the dense one (rtol 2e-4, atol 5e-5), the
        tolerances of tests/test_sharded_model.py;
      - the 5 norms, BatchNorm in batch mode (with its running
        statistics after the step) and in running mode, against dense
        (2e-4);
      - the ring plan against a2a (1e-5), its gradients against dense;
      - the pair model with GCN, GAT and TripletMessage protein towers
        against the dense ``PairArchitecture`` and the JAX package's;
      - the pair model with each of the 5 convs as its protein tower,
        a2a and ring, with ``GLAM_SHARDED_OVERLAP`` 1 and 0: outputs
        bitwise equal, gradients within rtol 1e-6 + atol 1e-8 (the JAX
        package's ``test_overlap_reorder_value_identical``), and the
        overlapped forward within 1e-4 of the JAX package's sharded
        forward;
      - two pairs packed in one step: each row equals its pair alone
        (1e-5), the gradients the mean of the pairs' (2e-4);
      - the noise at 2 shards against 1 shard with the same generator
        (1e-5), and at rate 0 against no noise (1e-6);
      - after one Adam step both ranks' parameters are bitwise equal;
      - the sharded trainer with BatchNorm and ``pair_batch=3`` (a
        short last chunk padded with weight-0 repeats), from the JAX
        ``ShardedPairTrainer``'s initial state, one epoch of SGD without
        noise: its losses and its best epoch's BatchNorm running
        statistics (both towers) within 1e-4 of the JAX trainer's.
The weights are the port's, drawn from a seed; the JAX model gets them
through the inverse of ``convert``'s naming, over the shapes of
``jax.eval_shape`` of its init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET, graphs_from_smiles
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.data.graph import GraphArrays as JaxGraph
from glam_tpu.nn import model as jax_model
from glam_tpu.parallel import sharded_model as jsm
from glam_tpu_torch import convert
from glam_tpu_torch.data.batching import GraphLoader
from glam_tpu_torch.data.graph import GraphArrays
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.parallel import sharded_model as sm
from test_torch_port_partition import contact_graph
from torch_port_dp_worker import spawn_ranks, wait_ranks

D = 2
CONVS = ["_TripletMessage", "_TripletMessageLight", "_NNConv", "_GCNConv",
         "_GATConv"]
READOUTS = ["GlobalLAPool", "GlobalPool5", "Set2Set"]
NORMS = ["_PairNorm", "_GraphSizeNorm", "_LayerNorm", "_BatchNorm_batch",
         "_BatchNorm_running"]
PRO = {"_GCNConv": "GlobalPool5", "_GATConv": "GlobalLAPool",
       "_TripletMessage": "Set2Set"}
QUIET = dict(pre_do="_None()", graph_do="_None()", flat_do="_None()",
             end_do="_None()", pre_act="CELU", graph_act="CELU",
             flat_act="CELU", end_act="CELU")
FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=5e-5)


def giant_graph(seed=0, N=120, E=360):
    """tests/test_sharded_model.py's random graph."""
    rng = np.random.RandomState(seed)
    return (rng.randn(N, 15).astype(np.float32),
            rng.randn(E, 4).astype(np.float32),
            rng.randint(0, N, E).astype(np.int32),
            rng.randint(0, N, E).astype(np.int32))


# ----------------------------------------------------------- host plans
@pytest.mark.parametrize("halo", ["a2a", "ring", "auto"])
@pytest.mark.parametrize("floors", [False, True])
def test_shard_inputs_equals_jax(halo, floors):
    nodes, edges, snd, rcv = contact_graph(L=100, n_long=6, seed=2)
    kw = {}
    if floors:
        kw = dict(node_budget=130, edge_budget=700)
        kw.update(halo_budget=40 if halo != "ring" else 0)
        if halo == "ring":
            kw["ring_budgets"] = (32,)
    for n_parts in (2, 4) if not floors else (2,):
        if "ring_budgets" in kw and n_parts != 2:
            continue
        want = jsm.shard_inputs(nodes, edges, snd, rcv, n_parts, halo=halo,
                                **kw)
        got = sm.shard_inputs(nodes, edges, snd, rcv, n_parts, halo=halo,
                              **kw)
        assert len(got) == len(want) == 9
        for a, b in zip(got, want):
            if isinstance(b, tuple):
                assert isinstance(a, tuple) and len(a) == len(b)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_stochastic_inputs_layout_and_shard_count():
    """The JAX package's layout (shapes, padding at keep 1 and the mean
    slope); the global draws are the same at 1, 2 and 4 shards."""
    N, C, S = 50, 6, 2
    glob = {}
    for n_parts in (1, 2, 4):
        drop, slope = sm.make_stochastic_inputs(
            torch.Generator().manual_seed(3), N, C, S, n_parts, rate=0.25)
        jd, js = jsm.make_stochastic_inputs(jax.random.PRNGKey(0), N, C, S,
                                            n_parts, rate=0.25)
        assert tuple(drop.shape) == jd.shape and tuple(slope.shape) == \
            js.shape
        Nl = drop.shape[2]
        flat_d = drop.transpose(0, 1).reshape(S, n_parts * Nl, C)
        flat_s = slope.transpose(0, 1).reshape(S, n_parts * Nl, C)
        jflat = jd.transpose(1, 0, 2, 3).reshape(S, n_parts * Nl, C)
        np.testing.assert_array_equal(flat_d[:, N:].numpy(), jflat[:, N:])
        np.testing.assert_allclose(
            flat_s[:, N:].numpy(),
            js.transpose(1, 0, 2, 3).reshape(S, -1, C)[:, N:])
        assert set(np.unique(flat_d[:, :N].numpy())) <= {
            0.0, np.float32(1 / 0.75)}
        assert float(flat_s.min()) >= 1 / 8 and float(flat_s.max()) <= 1 / 3
        glob[n_parts] = (flat_d[:, :N], flat_s[:, :N])
    for n_parts in (2, 4):
        for a, b in zip(glob[n_parts], glob[1]):
            assert torch.equal(a, b)
    keep = float((glob[1][0] > 0).float().mean())
    assert 0.65 < keep < 0.85


# ---------------------------------------------------------- dense sides
def _port_model(cfg_kw, pair=False, seed=1):
    cfg = port_model.ModelConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    return (port_model.PairArchitecture(cfg, hetero=True, generator=gen)
            if pair else port_model.Architecture(cfg, gen))


def _jax_params(shapes, state):
    """The JAX parameter tree of ``shapes`` (``eval_shape`` of the init)
    filled from the port's ``state``, by convert's naming rules."""
    def fill(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            name, transpose = convert._LEAVES.get(k, (k, False))
            key = ".".join([convert._MODULES.get(m, m) for m in path]
                           + [name])
            arr = state[key].numpy()
            arr = arr.T if transpose else arr
            assert arr.shape == v.shape, key
            out[k] = jnp.asarray(arr)
        return out
    return fill(shapes, ())


def _jax_batch(gs):
    return next(iter(JaxLoader([JaxGraph(*g) for g in gs], len(gs), 1)))


def _port_batch(gs):
    return next(iter(GraphLoader([GraphArrays(*g) for g in gs], len(gs),
                                 1)))


def _dense(model, batches, train=False, n_out=1):
    """The dense model's outputs, its loss (MSE to 0.3) gradients and its
    BatchNorm statistics after the forward."""
    model.train(train)
    out = model(*batches)[:n_out]
    ((out - 0.3) ** 2).mean().backward()
    grads = {k: (p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return {"out": out.detach(), "grads": grads,
            "buffers": {k: v.clone() for k, v in model.named_buffers()
                        if k.endswith((".mean", ".var"))}}


def _jax_out(jcls, jcfg, state, jbatches, stats=None):
    model = jcls(jcfg, hetero=True) if jcls is jax_model.PairArchitecture \
        else jcls(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               *jbatches, True))
    variables = {"params": _jax_params(shapes["params"], state)}
    if "batch_stats" in shapes:
        variables["batch_stats"] = _jax_params(shapes["batch_stats"], stats)
    return np.asarray(model.apply(variables, *jbatches, True))


def _jax_sharded_out(case):
    """The JAX package's sharded pair forward (``make_sharded_pair_forward``,
    its overlap on, the default) on the case's first pair over D CPU
    devices, a2a."""
    from glam_tpu.parallel.data_parallel import make_mesh
    cfg = jax_model.ModelConfig(**case["cfg"])
    pro = case["graphs"][0]
    g1 = _jax_batch(case["mols"][:1])
    g2 = _jax_batch([(*pro, np.zeros(1, np.float32))])
    model = jax_model.PairArchitecture(cfg, hetero=True)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), g1,
                                               g2, True))
    params = jsm.extract_pair_params(
        _jax_params(shapes["params"], case["state"]), cfg.pro_block,
        cfg.pro_readout)
    fwd = jsm.make_sharded_pair_forward(
        make_mesh(jax.devices()[:D], ("graph",)), cfg)
    inputs = tuple(jnp.asarray(a) for a in jsm.shard_inputs(*pro, D))
    return np.asarray(fwd(params, g1, *inputs))


def single_cfg(conv, readout, norm="_None", N=120):
    return dict(mol_block=conv, mol_readout=readout, message_steps=2,
                e_dim=64, hid_dim_alpha=2, max_nodes=N + 8, graph_norm=norm,
                **QUIET)


def pair_cfg(pro_block, pro_readout, **kw):
    return dict(dict(mol_block="_TripletMessage", mol_readout="GlobalPool5",
                     pro_block=pro_block, pro_readout=pro_readout,
                     pro_in_dim=12, pro_edge_in_dim=8, message_steps=2,
                     e_dim=32, hid_dim_alpha=2, max_nodes=64,
                     pro_max_nodes=128, out_dim=2, **QUIET), **kw)


def _loaded(case):
    """A dense port model holding the case's state."""
    model = _port_model(case["cfg"], pair=case["kind"] == "pair")
    model.load_state_dict(case["state"])
    return model


def _cases():
    """The ranks' cases (``sharded.pt``): weights from seeds."""
    giant = giant_graph()
    proteins = [contact_graph(L=120, seed=0), contact_graph(L=120, seed=5)]
    mols = [tuple(m) for m in graphs_from_smiles(SMILES_SET[2:4])]
    cases = {}
    for conv in CONVS:
        for ro in READOUTS:
            cfg = single_cfg(conv, ro)
            cases[f"{conv}_{ro}"] = dict(
                kind="single", cfg=cfg, state=_port_model(cfg).state_dict(),
                graphs=[giant], ring=ro == "GlobalPool5")
    for norm in NORMS:
        gn, mode = (norm.rsplit("_", 1) if norm.startswith("_BatchNorm")
                    else (norm, "eval"))
        cfg = single_cfg("_TripletMessage", "GlobalLAPool", gn)
        model = _port_model(cfg)
        if mode == "running":          # running statistics to read
            rng, C = np.random.RandomState(7), model.cfg.hid_dim
            model.mol.conv.norm.mean.copy_(torch.from_numpy(
                rng.randn(C).astype(np.float32) * 0.1))
            model.mol.conv.norm.var.copy_(torch.from_numpy(
                rng.rand(C).astype(np.float32) + 0.5))
        cases[norm] = dict(kind="single", cfg=cfg, graphs=[giant],
                           state={k: v.clone() for k, v in
                                  model.state_dict().items()},
                           train=mode == "batch", sgd=mode == "batch")
    for pro, ro in PRO.items():
        cfg = pair_cfg(pro, ro)
        cases[f"pair{pro}"] = dict(
            kind="pair", cfg=cfg,
            state=_port_model(cfg, pair=True).state_dict(),
            graphs=proteins, mols=mols, batched=pro == "_GATConv",
            adam=pro == "_TripletMessage", sgd=pro == "_GCNConv")
    for conv in CONVS:
        cfg = pair_cfg(conv, "GlobalLAPool")
        cases[f"overlap{conv}"] = dict(
            kind="pair", cfg=cfg, graphs=proteins[:1], mols=mols[:1],
            state=_port_model(cfg, pair=True).state_dict(), overlap=True)
    for act in ("CELU", "RReLU"):
        cfg = pair_cfg("_GATConv", "GlobalPool5", graph_act=act)
        cases[f"noise_{act}"] = dict(
            kind="pair", cfg=cfg, graphs=proteins[:1],
            state=_port_model(cfg, pair=True).state_dict(),
            mols=mols[:1], noise=True)
    return cases


def _references(cases):
    """Each case's dense references: the port's outputs, gradients and
    statistics (and the BatchNorm case's SGD step), and the JAX
    package's outputs."""
    giant = cases["_PairNorm"]["graphs"][0]
    jb = _jax_batch([(*giant, np.zeros(1, np.float32))])
    pb = _port_batch([(*giant, np.zeros(1, np.float32))])
    dense = {}
    for name, case in cases.items():
        if name.startswith("noise_"):
            continue
        if case.get("overlap"):
            dense[name] = {"jax_sharded": _jax_sharded_out(case)}
            continue
        model = _loaded(case)
        if case["kind"] == "single":
            dense[name] = _dense(model, (pb,), train=case.get("train",
                                                             False))
            if name in NORMS:
                if case.get("sgd"):      # one SGD step (lr 0.1) of the loss
                    with torch.no_grad():
                        for k, p in model.named_parameters():
                            p -= 0.1 * dense[name]["grads"][k]
                    dense[name]["sgd"] = {k: v.clone() for k, v in
                                          model.state_dict().items()}
                continue
            dense[name]["jax"] = _jax_out(
                jax_model.Architecture, jax_model.ModelConfig(**case["cfg"]),
                case["state"], (jb,))
            continue
        pros = [(*p, np.zeros(1, np.float32)) for p in case["graphs"]]
        dense[name] = _dense(model, (_port_batch(case["mols"][:1]),
                                     _port_batch(pros[:1])))
        dense[name]["jax"] = _jax_out(
            jax_model.PairArchitecture, jax_model.ModelConfig(**case["cfg"]),
            case["state"], (_jax_batch(case["mols"][:1]),
                            _jax_batch(pros[:1])))
        if case.get("batched"):
            dense[name]["both"] = _dense(
                _loaded(case), (_port_batch(case["mols"]),
                                _port_batch(pros)), n_out=2)
    return dense


# SGD, for the reason test_torch_port_sharded_trainer.py's ARGS give
BN_ARGS = dict(dataset="bindingdb_c", pro_shards=2, lr=1e-3, optim="SGD",
               seed=3,
               e_dim=32, hid_dim_alpha=2, message_steps=2,
               mol_block="_TripletMessage", pro_block="_GATConv",
               pro_readout="GlobalLAPool", mol_readout="GlobalPool5",
               graph_norm="_BatchNorm", pair_batch=3, epochs=1, **QUIET)


def _bn_trainer(work):
    """The JAX sharded trainer with BatchNorm on 13 BindingDB pairs (a
    last chunk of 1 at pair_batch 3), and the port's run of it from the
    JAX trainer's initial state."""
    from glam_tpu.data import pair_datasets as jax_pairs
    from glam_tpu.train.sharded_pair_trainer import ShardedPairTrainer
    from test_torch_port_sharded_trainer import dti_copy
    root = dti_copy(work / "bn_data", (13, 6, 6))
    jt = ShardedPairTrainer(dict(BN_ARGS), jax_pairs.BindingDBDataset(
        str(root)), task="pair_binary", work_dir=str(work / "jax_bn"))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = convert.state_dict_from_jax(
        tree(jt._flax_params), convert.config_from_args(jt.args),
        tree(jt._pair_bn0), pair="hetero")
    torch.save({"bn": {"args": BN_ARGS, "root": str(root), "init": init}},
               work / "strainer.pt")
    return jt


def _jax_bn_run(jt):
    """The JAX trainer's epoch: its validation losses, final losses and
    best epoch's BatchNorm statistics in the port's names."""
    rec = {"val": []}
    valid = jt.valid_iterations

    def valid_rec(mode="valid"):
        out = valid(mode)
        rec["val"].append(out[0])
        return out

    jt.valid_iterations = valid_rec
    rec["final"] = jt.train_and_test()
    stats = jsm.insert_pair_bn_stats(jt._pair_bn0, jt._mol_bn, jt._pro_ra)
    rec["stats"] = convert.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jt._flax_params),
        convert.config_from_args(jt.args),
        jax.tree_util.tree_map(np.asarray, stats), pair="hetero")
    return rec


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Rank 0's results of every case and of the BatchNorm trainer run,
    and the references (the port's dense models, the JAX package's, the
    JAX trainer's run), computed while the ranks run."""
    work = tmp_path_factory.mktemp("sharded")
    cases = _cases()
    torch.save(cases, work / "sharded.pt")
    jt = _bn_trainer(work)
    (work / "plan.json").write_text('{"tasks": ["sharded", "strainer"]}')
    procs = spawn_ranks(work, "cpu")
    dense = _references(cases)
    dense["bn_trainer"] = _jax_bn_run(jt)
    got = wait_ranks(procs, work, timeout=600)
    got["sharded"]["bn_trainer"] = got["strainer"]["bn"]
    return got["sharded"], dense


def _close_tree(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        torch.testing.assert_close(got[k], want[k], **tol,
                                   msg=f"{what}: {k}")


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("readout", READOUTS)
def test_conv_readout_forward_and_gradients(sharded_run, conv, readout):
    got, dense = sharded_run
    got, want = got[f"{conv}_{readout}"], dense[f"{conv}_{readout}"]
    torch.testing.assert_close(got["a2a"]["out"], want["out"], **FWD)
    np.testing.assert_allclose(got["a2a"]["out"].numpy(), want["jax"][:1],
                               **FWD)
    _close_tree(got["a2a"]["grads"], want["grads"], GRAD, "gradients")


@pytest.mark.parametrize("norm", NORMS)
def test_norms_match_dense(sharded_run, norm):
    got, dense = sharded_run
    got, want = got[norm]["a2a"], dense[norm]
    tol = dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got["out"], want["out"], **tol)
    _close_tree(got["grads"], want["grads"], GRAD, "gradients")
    _close_tree(got["buffers"], want["buffers"], tol, "running statistics")
    if norm == "_BatchNorm_batch":   # the EMA moved the statistics
        fresh = _port_model(single_cfg("_TripletMessage", "GlobalLAPool",
                                       "_BatchNorm")).mol.conv.norm
        assert not torch.allclose(got["buffers"]["mol.conv.norm.mean"],
                                  fresh.mean)


@pytest.mark.parametrize("conv", CONVS)
def test_ring_equals_a2a(sharded_run, conv):
    got, dense = sharded_run
    name = f"{conv}_GlobalPool5"
    got, want = got[name], dense[name]
    torch.testing.assert_close(got["ring"]["out"], got["a2a"]["out"],
                               rtol=1e-5, atol=1e-5)
    _close_tree(got["ring"]["grads"], want["grads"], GRAD, "ring gradients")


@pytest.mark.parametrize("pro", list(PRO))
def test_pair_forward_and_gradients(sharded_run, pro):
    got, dense = sharded_run
    got, want = got[f"pair{pro}"]["a2a"], dense[f"pair{pro}"]
    torch.testing.assert_close(got["out"], want["out"], **FWD)
    np.testing.assert_allclose(got["out"].numpy(), want["jax"][:1], **FWD)
    _close_tree(got["grads"], want["grads"], GRAD, "gradients")


@pytest.mark.parametrize("name", ["_BatchNorm_batch", "pair_GCNConv"])
def test_sgd_train_steps_match_dense(sharded_run, name):
    """``make_sharded_train_step`` (BatchNorm in batch mode: its running
    statistics move too) and ``make_sharded_pair_train_step``: one SGD
    step (lr 0.1) equals the dense model's step on the same loss."""
    got, dense = sharded_run
    want = dense[name].get("sgd")
    if want is None:                 # the pair model's dense step
        model = _port_model(pair_cfg("_GCNConv", "GlobalPool5"), pair=True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p -= 0.1 * dense[name]["grads"][k]
        want = model.state_dict()
    _close_tree(got[name]["sgd"], want, dict(rtol=2e-4, atol=5e-5),
                "state after the step")


def test_two_pairs_in_one_step(sharded_run):
    got, dense = sharded_run
    got, want = got["pair_GATConv"], dense["pair_GATConv"]["both"]
    both, alone = got["both"], got["alone"]
    for b in range(2):
        torch.testing.assert_close(both["out"][b], alone[b]["out"][0],
                                   rtol=1e-5, atol=1e-5)
    mean = {k: (alone[0]["grads"][k] + alone[1]["grads"][k]) / 2
            for k in both["grads"]}
    _close_tree(both["grads"], mean, GRAD, "mean of the pairs' gradients")
    torch.testing.assert_close(both["out"], want["out"], **FWD)
    _close_tree(both["grads"], want["grads"], GRAD, "dense two-pair batch")


@pytest.mark.parametrize("act", ["CELU", "RReLU"])
def test_noise_is_the_same_at_one_and_two_shards(sharded_run, act):
    got, _ = sharded_run
    got = got[f"noise_{act}"]
    torch.testing.assert_close(got["noise_d2"]["out"],
                               got["noise_d1"]["out"], rtol=1e-5, atol=1e-5)
    _close_tree(got["noise_d2"]["grads"], got["noise_d1"]["grads"], GRAD,
                "noisy gradients")
    assert not torch.allclose(got["noise_d2"]["out"], got["a2a"]["out"])
    if act == "CELU":                # rate 0 and no RReLU: no noise at all
        torch.testing.assert_close(got["rate0"]["out"], got["a2a"]["out"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("conv", CONVS)
def test_overlap_reorder_value_identical(sharded_run, conv):
    """tests/test_sharded_model.py's test of the same name, on 2 gloo
    ranks: ``GLAM_SHARDED_OVERLAP=0`` (each halo waited for where it is
    issued, each step's fusion statistics taken after it) and the default
    overlap (the table-free terms and the previous step's statistics
    while the halo is in flight) compute the same function, a2a and
    ring: outputs bitwise equal, gradients within the JAX test's
    tolerance.  The overlapped forward stays within 1e-4 of the JAX
    package's overlapped sharded forward."""
    got, dense = sharded_run
    got, want = got[f"overlap{conv}"], dense[f"overlap{conv}"]
    for halo in ("a2a", "ring"):
        on, off = got["overlap"][halo]["1"], got["overlap"][halo]["0"]
        assert torch.equal(on["out"], off["out"]), halo
        _close_tree(on["grads"], off["grads"], dict(rtol=1e-6, atol=1e-8),
                    f"{halo} gradients, overlap on against off")
    np.testing.assert_allclose(got["overlap"]["a2a"]["1"]["out"].numpy()[0],
                               want["jax_sharded"], **FWD)


def test_adam_step_leaves_the_ranks_equal(sharded_run):
    got, _ = sharded_run
    states = got["pair_TripletMessage"]["adam"]
    assert len(states) == 2
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    cfg = pair_cfg("_TripletMessage", "Set2Set")
    start = _port_model(cfg, pair=True).state_dict()
    assert not torch.equal(states[0]["lin_out1.linear.weight"],
                           start["lin_out1.linear.weight"])


def test_batchnorm_trainer_matches_jax(sharded_run):
    got, dense = sharded_run
    got, want = got["bn_trainer"], dense["bn_trainer"]
    np.testing.assert_allclose(got["records"]["val_losses"],
                               want["val"][:1], rtol=1e-4)
    for k in ("testloss", "valloss"):
        assert got["final"][0][k] == pytest.approx(
            want["final"][0][k], rel=1e-4), k
    stats = [k for k in want["stats"] if k.endswith((".mean", ".var"))]
    assert len(stats) == 4                 # both towers' BatchNorm
    for k in stats:
        torch.testing.assert_close(got["params"][0][k], want["stats"][k],
                                   rtol=1e-4, atol=1e-4, msg=k)
