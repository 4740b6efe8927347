"""The JAX trainer's one-dispatch steps in the port, on the CPU (the
card's CUDA graphs are held in ``test_torch_port_cuda.py``):

  * kernels A and B's plain versions, through their CPU route, over a
    CSR padded to the edge budget (``data/graph.py:budget_csr``) against
    the same CSR without the padded slots, exactly, and against the JAX
    package's Pallas ``fused_triplet_attention`` (interpret mode) or,
    for a row longer than its packing takes,
    ``triplet_attention_reference``: forward and gradients within 1e-5
    (float32 sums in another order);
  * the port's ``Trainer`` at ``--scan_steps`` 1, 3 and 8 against the JAX
    ``Trainer`` at the same setting over 9 batches an epoch, with a tail
    group and a group whose batches differ in shape: the epochs' losses
    within 1e-4 relative (float32 sums in other orders through the
    epochs' Adam steps, as ``test_torch_port_train.py``);
  * Ranger's step on a device-side step count against the host-counted
    step it replaced, over 13 steps (its N_sma threshold at step 6 and
    Lookahead syncs at steps 6 and 12) and through a state_dict round
    trip: within 1e-6 (the same float32 formulas; the scalars' float64
    powers may differ in the last bit);
  * ``set_learning_rate`` on a tensor learning rate, written in place.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glam_tpu.data import batching as jax_batching
from glam_tpu.data import datasets as jax_datasets
from glam_tpu.ops.pallas.triplet_fused import (fused_triplet_attention,
                                               pack_blocks2,
                                               triplet_attention_reference)
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert
from glam_tpu_torch.data import batching as port_batching
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.data.graph import budget_csr, receiver_csr
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.ops.kernels.triplet_fused import (
    triplet_attention, triplet_attention_fwd)
from glam_tpu_torch.train import optim as port_optim
from glam_tpu_torch.train import trainer as port_trainer
from test_torch_port_backward import NAMES, PAD, _graph, _inputs
from test_torch_port_model import _cfg, _np_tree
from test_torch_port_train import _raw_copy, _record_losses


# ------------------------------------------- kernels A and B's padded CSR
def _run_plain(host, g, rowptr, snd, eid, H, C):
    """(out, row_max, row_inv, every input's gradient) through the
    forward's CPU route (the plain version) and the Function's plain
    backward."""
    t = [torch.from_numpy(a).requires_grad_(True) for a in host]
    csr = [torch.from_numpy(a) for a in (rowptr, snd, eid)]
    stats = triplet_attention_fwd(*[a.detach() for a in t], *csr, H, C)
    triplet_attention(*t, *csr, H, C).backward(torch.from_numpy(g))
    return list(stats) + [a.grad for a in t]


@pytest.mark.parametrize("case,heads,channels", [("random", 3, 8),
                                                 ("hub", 2, 5)])
def test_triplet_plain_over_the_budget_csr(case, heads, channels):
    H, C = heads, channels
    rng = np.random.RandomState(11)
    snd, rcv, N = _graph(rng, case)
    E_real, E = len(snd), len(snd) + PAD
    host = _inputs(rng, N, E, H, C)
    g = rng.randn(N, H * C).astype(np.float32)
    g[-1] = 0.0
    rowptr, csr_snd, csr_eid = receiver_csr(snd, rcv, N)
    pad_snd, pad_eid = budget_csr(rowptr, csr_snd, csr_eid, E)[:2]
    assert len(pad_snd) == E and int(rowptr[-1]) == E_real
    real = _run_plain(host, g, rowptr, csr_snd, csr_eid, H, C)
    padded = _run_plain(host, g, rowptr, pad_snd, pad_eid, H, C)
    for a, b in zip(real, padded):
        assert torch.equal(a, b)

    got = dict(zip(NAMES, (a.numpy() for a in padded[3:])))
    j = [jnp.asarray(a) for a in host]
    snd_all = np.concatenate([snd, np.full(PAD, N - 1, np.int32)])
    rcv_all = np.concatenate([rcv, np.full(PAD, N - 1, np.int32)])
    if case == "hub":       # the Pallas packing takes 256 edges a row
        def fn(*a):
            return triplet_attention_reference(
                *a, jnp.asarray(snd_all), jnp.asarray(rcv_all), H, C)
    else:
        pk = pack_blocks2(snd, rcv, N)
        packed = [jnp.asarray(v) for v in (pk.perm, pk.local_rcv,
                                           pk.local_snd, pk.win_start,
                                           pk.edge_mask)]
        j = j[:3] + [j[3][:E_real]] + j[4:]
        got["edge_attr"] = got["edge_attr"][:E_real]

        def fn(*a):
            return fused_triplet_attention(H, C, 0.2, True, *a,
                                           jnp.asarray(snd),
                                           jnp.asarray(rcv), *packed)
    out, vjp = jax.vjp(fn, *j)
    np.testing.assert_allclose(padded[0].numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    want = dict(zip(NAMES, (np.asarray(x) for x in vjp(jnp.asarray(g)))))
    for name in NAMES:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


# -------------------------------------------------- the grouped trainer
SCAN_ARGS = {"dataset": "demo", "epochs": 1, "batch_size": 9, "e_dim": 16,
             "hid_dim_alpha": 1, "message_steps": 1, "loss": "bcel",
             "optim": "Adam", "lr": 1e-3, "seed": 5,
             "mol_block": "_TripletMessage", "pre_act": "CELU",
             "graph_act": "CELU", "flat_act": "CELU", "pre_do": "_None()",
             "graph_do": "_None()", "flat_do": "_None()",
             "end_do": "_None()"}


class _TwoShapes:
    """A training loader whose last ``k`` batches of every epoch come
    from a twin loader with a larger edge budget: the same graphs in the
    same order, another shape, so that a group spanning the change is not
    stackable (the JAX trainer's ``_stackable``)."""

    def __init__(self, module, loader, k=2):
        self.a, self.k = loader, k
        extra = {key: getattr(loader, key) for key in ("ell_k",
                                                       "pallas_pack")
                 if hasattr(loader, key)}
        self.b = module.GraphLoader(loader.graphs, loader.batch_size,
                                    loader.num_tasks, shuffle=True,
                                    seed=loader.seed,
                                    node_budget=loader.node_budget,
                                    edge_budget=loader.edge_budget + 8,
                                    **extra)

    def __len__(self):
        return len(self.a)

    def set_epoch(self, epoch):
        self.a.set_epoch(epoch)
        self.b.set_epoch(epoch)

    def __iter__(self):
        n = len(self.a)
        for i, (a, b) in enumerate(zip(self.a, self.b)):
            yield b if i >= n - self.k else a


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    return _raw_copy(tmp_path_factory.mktemp("data"), "demo", 100)


class _Dispatches:
    """Stands in for the card's ``StepGraphs`` on the CPU: records each
    dispatch (kind, items, one S-step graph or item by item) and runs the
    trainer's eager steps in its place."""

    def __init__(self, trainer):
        self.t, self.calls = trainer, []

    def train(self, group, stack):
        self.calls.append(("train", len(group), stack))
        return torch.stack([self.t._step(self.t._to_device(p))
                            for p in group])

    def evaluate(self, group, stack):
        self.calls.append(("eval", len(group), stack))
        res = [self.t._eval_step(self.t._to_device(p)) for p in group]
        return (torch.stack([o for o, _ in res]),
                torch.stack([l for _, l in res]))


# the JAX trainer's flush of 9 batches, the last 2 of another shape
DISPATCHES = {1: [("train", 1, False)] * 9,
              3: [("train", 3, True), ("train", 3, True),
                  ("train", 3, False)],
              8: [("train", 8, False), ("train", 1, False)]}


@pytest.mark.parametrize("scan", [1, 3, 8])
def test_grouped_trainer_matches_jax(tmp_path, demo_root, scan):
    """80 training molecules in batches of 9 (9 batches, the last of 8):
    at S = 3 three full groups, at S = 8 one full group and a tail of 1;
    the last 2 batches have another edge budget, so S = 3's last group
    and S = 8's first run batch by batch (as the JAX trainer's
    ``flush``).  The port's dispatches are recorded (``_Dispatches``)."""
    args = dict(SCAN_ARGS, dataset_root=str(demo_root), scan_steps=scan)
    args, ds, kind = jax_datasets.auto_dataset(args)
    tj = jax_trainer.make_trainer(args, ds, kind,
                                  work_dir=str(tmp_path / "jax"))
    pds = port_datasets.MolDataset(str(demo_root), "demo")
    tp = port_trainer.make_trainer(args, pds, kind,
                                   work_dir=str(tmp_path / "port"),
                                   device="cpu")
    assert tp.step_graphs is None
    tp.model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(tj.state.params), tp.model.cfg))
    tj.train_loader = _TwoShapes(jax_batching, tj.train_loader)
    tp.train_loader = _TwoShapes(port_batching, tp.train_loader)
    assert len(tp.train_loader) == 9
    tp.step_graphs = _Dispatches(tp)
    rec_j, rec_p = _record_losses(tj, True), _record_losses(tp, False)
    tj.train()
    tp.train()
    assert len(rec_p["trn"]) == len(rec_j["trn"]) == 1
    np.testing.assert_allclose(rec_p["trn"], rec_j["trn"], rtol=1e-4)
    np.testing.assert_allclose(rec_p["val"], rec_j["val"], rtol=1e-4)
    assert tp.step == 9
    # one validation batch (10 molecules): one dispatch of one item
    assert tp.step_graphs.calls == DISPATCHES[scan] + [("eval", 1, False)]


# ----------------------------------------------------------- optimizers
class _HostRanger(torch.optim.Optimizer):
    """The port's Ranger before its step moved to the device: a host step
    count per parameter, each branch taken in Python."""

    def __init__(self, named_params, lr=1e-3, k=6, alpha=0.5,
                 betas=(0.95, 0.999), eps=1e-5, threshold=5.0):
        named = list(named_params)
        super().__init__([p for _, p in named],
                         dict(lr=lr, k=k, alpha=alpha, betas=betas, eps=eps,
                              threshold=threshold))
        self._gc = [port_optim.gc_dims(n, p.dim()) for n, p in named]

    @torch.no_grad()
    def step(self):
        group = self.param_groups[0]
        lr, k, alpha = group["lr"], group["k"], group["alpha"]
        (b1, b2), eps = group["betas"], group["eps"]
        for p, dims in zip(group["params"], self._gc):
            g = p.grad
            if dims:
                g = g - g.mean(dim=dims, keepdim=True)
            st = self.state[p]
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                st["slow"] = p.detach().clone()
            st["step"] += 1
            t = st["step"]
            m, v = st["exp_avg"], st["exp_avg_sq"]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            b2t = b2 ** t
            n_max = 2.0 / (1.0 - b2) - 1.0
            n_sma = n_max - 2.0 * t * b2t / (1.0 - b2t)
            bias1 = 1.0 - b1 ** t
            if n_sma > group["threshold"]:
                rect = math.sqrt((1.0 - b2t) * (n_sma - 4.0) / (n_max - 4.0)
                                 * (n_sma - 2.0) / n_sma
                                 * n_max / (n_max - 2.0)) / bias1
                p.addcdiv_(m, v.sqrt().add_(eps), value=-lr * rect)
            else:
                p.add_(m, alpha=-lr / bias1)
            if t % k == 0:
                slow = st["slow"]
                slow.add_(p - slow, alpha=alpha)
                p.copy_(slow)


def _two_models(seed=2):
    cfg = _cfg(port_model.ModelConfig)
    a = port_model.Architecture(cfg, torch.Generator().manual_seed(seed))
    b = port_model.Architecture(cfg, torch.Generator().manual_seed(seed))
    return a, b


def _set_grads(models, rng):
    for named in zip(*(m.named_parameters() for m in models)):
        g = torch.from_numpy(rng.randn(*named[0][1].shape).astype(
            np.float32) + 0.5)
        for _, p in named:
            p.grad = g.clone()


def test_device_step_ranger_matches_the_host_step():
    host_model, model = _two_models()
    host = _HostRanger(host_model.named_parameters(), lr=1e-2, k=6)
    opt = port_optim.make_optimizer("Ranger", model.named_parameters(),
                                    1e-2, k=6)
    assert isinstance(opt.param_groups[0]["step"], torch.Tensor)
    rng = np.random.RandomState(4)
    for step in range(13):
        if step == 7:       # through a checkpoint's state_dict
            state = opt.state_dict()
            opt = port_optim.make_optimizer(
                "Ranger", model.named_parameters(), 1e-2, k=6)
            port_optim.load_optimizer_state(opt, state)
        _set_grads((host_model, model), rng)
        host.step()
        opt.step()
        for (name, a), b in zip(host_model.named_parameters(),
                                model.parameters()):
            np.testing.assert_allclose(b.detach().numpy(),
                                       a.detach().numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{step} {name}")
    assert float(opt.param_groups[0]["step"]) == 13


def test_set_learning_rate_on_a_tensor_lr():
    """A tensor learning rate (the card's: a captured step reads it) is
    written in place; a step then moves as one with that float rate."""
    a, b = _two_models()
    lr = torch.tensor(0.1)
    opt = torch.optim.Adam(a.parameters(), lr=lr)
    ref = torch.optim.Adam(b.parameters(), lr=0.1)
    rng = np.random.RandomState(6)
    for step in range(3):
        if step == 1:
            port_optim.set_learning_rate(opt, 0.025)
            port_optim.set_learning_rate(ref, 0.025)
            assert opt.param_groups[0]["lr"] is lr
            assert float(lr) == pytest.approx(0.025)
            assert port_optim.get_learning_rate(opt) == pytest.approx(0.025)
        _set_grads((a, b), rng)
        opt.step()
        ref.step()
    for pa, pb in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    # a checkpoint's tensor learning rate comes back a tensor
    state = opt.state_dict()
    again = torch.optim.Adam(a.parameters(), lr=torch.tensor(1.0))
    port_optim.load_optimizer_state(again, state)
    assert isinstance(again.param_groups[0]["lr"], torch.Tensor)
    assert float(again.param_groups[0]["lr"]) == pytest.approx(0.025)
