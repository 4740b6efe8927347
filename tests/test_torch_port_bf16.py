"""``--dtype bfloat16`` (and ``float16``) training against the JAX
package's mixed precision, on the CPU.

Both sides cast the float32 master parameters and the batch's float
leaves to the compute dtype inside the differentiated function and take
the loss in float32 (JAX ``trainer.py:262-320``; the port's
``Trainer.forward``).  From the same weights and batch (models in
evaluation mode, so no noise is drawn), on three models (the flagship;
TripletMessageLight + Set2Set with BatchNorm; GAT + GlobalLAPool):

  * the outputs, and every tensor of the gradient tree, agree within
    ``TOL`` times the largest entry of the float32 output (of the float32
    gradient tree): bfloat16 keeps 8 bits of mantissa (3.9e-3 relative
    per rounding) and a forward and backward through the message steps
    compound dozens of roundings, so that the two packages' bfloat16
    runs differ by up to 0.096 of the flagship's output here (float16,
    11 bits: 0.002 on the Set2Set model; the flagship's float16
    gradients overflow to NaN at this initialisation in both packages);
  * the port's result lies no further from the float32 result than twice
    the JAX package's does (measured: at most 1.5 times; the port's
    kernels compute the attention softmaxes in float32 where the JAX XLA
    path computes them in bfloat16, ROADMAP §C);
  * the gradients arrive in float32.

The masters stay float32 after a step, and a 2-epoch run's per-epoch
losses agree within 2e-2 relative."""
import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMILES_SET
from glam_tpu.data import datasets as jax_datasets
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import model as jax_model
from glam_tpu.train import trainer as jax_trainer
from glam_tpu_torch import convert, run
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.train import trainer as port_trainer
from test_torch_port_model import _np_tree, _port_batch
from test_torch_port_train import (TRAIN_ARGS, _raw_copy, _record_losses)

TOL = {"bfloat16": 0.15, "float16": 0.02}
CONFIGS = {
    "flagship": dict(mol_block="_TripletMessage", graph_norm="_PairNorm"),
    "light_set2set_bn": dict(mol_block="_TripletMessageLight",
                             mol_readout="Set2Set", graph_norm="_BatchNorm",
                             flat_norm="_BatchNorm"),
    "gat_lapool": dict(mol_block="_GATConv", mol_readout="GlobalLAPool",
                       pre_norm="_LayerNorm"),
}


def _cfg(cls, **kw):
    base = dict(hid_dim_alpha=2, e_dim=32, message_steps=2, max_nodes=32,
                pre_act="CELU", graph_act="CELU", flat_act="CELU",
                end_act="CELU")
    base.update(kw)
    return cls(**base)


def _jax_grads(model, variables, batch, loss_fn, dtype):
    """The JAX trainer's mixed-precision loss and gradients, in
    evaluation mode."""
    dt = jnp.dtype(dtype)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(dt) if hasattr(a, "dtype")
        and a.dtype == jnp.float32 else a, t)
    cbatch = cast(batch)

    def f(p):
        v = dict(variables, params=cast(p))
        out = model.apply(v, cbatch, True)
        return loss_fn(out.astype(jnp.float32), batch.y,
                       batch.graph_mask), out

    (loss, out), grads = jax.value_and_grad(f, has_aux=True)(
        variables["params"])
    return loss, out, grads


def _trainer(tmp_path, cfg, dtype):
    args = {"dtype": dtype, "loss": "bcel", "task": "binary_nan_bce",
            "num_tasks": 1, "dataset": "demo"}
    model = port_model.Architecture(cfg)
    return port_trainer.Trainer(args, model, [], [], print_log=False,
                                work_dir=str(tmp_path), device="cpu")


def _jax_side(name, sample_graphs, dtype):
    jcfg = _cfg(jax_model.ModelConfig, **CONFIGS[name])
    jb = next(iter(JaxLoader(sample_graphs, batch_size=6, num_tasks=1)))
    jb = jb._replace(y=jnp.asarray(
        np.random.RandomState(0).randint(0, 2, jb.y.shape), jnp.float32))
    model = jax_model.Architecture(jcfg)
    variables = model.init(jax.random.PRNGKey(4), jb, True)
    loss_fn = jax_trainer.make_loss_fn("binary_nan_bce", "bcel", 1)
    return jb, variables, {dt: _jax_grads(model, variables, jb, loss_fn, dt)
                           for dt in (dtype, "float32")}


def _port_side(tmp_path, name, variables, y, dtype):
    tp = _trainer(tmp_path, _cfg(port_model.ModelConfig, **CONFIGS[name]),
                  dtype)
    stats = variables.get("batch_stats")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(variables["params"]), tp.model.cfg,
        _np_tree(stats) if stats else None))
    pb = _port_batch(SMILES_SET)
    pb = pb.__class__(**{**pb.__dict__, "y": torch.tensor(y)})
    tp.model.eval()
    out = tp.forward((pb,))
    assert out.dtype == torch.float32
    loss = tp.loss_fn(out, pb.y, pb.graph_mask)
    loss.backward()
    for n, p in tp.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
    return (float(loss), out.detach().numpy(),
            {n: p.grad.numpy() for n, p in tp.model.named_parameters()})


@pytest.mark.parametrize("case", ["flagship-bfloat16",
                                  "light_set2set_bn-bfloat16",
                                  "gat_lapool-bfloat16",
                                  "light_set2set_bn-float16"])
def test_forward_and_gradients_match_jax(tmp_path, sample_graphs, case):
    name, dtype = case.split("-")
    jb, variables, jax_res = _jax_side(name, sample_graphs, dtype)
    cfg = _cfg(port_model.ModelConfig, **CONFIGS[name])
    y = np.asarray(jb.y)
    loss_p, out_p, grads_p = _port_side(tmp_path / "a", name, variables, y,
                                        dtype)
    loss_j, out_j, grads_j = jax_res[dtype]
    _, out_32, grads_32 = jax_res["float32"]
    out_j, out_32 = (np.asarray(o, np.float32) for o in (out_j, out_32))
    grads_j, grads_32 = (convert.state_dict_from_jax(_np_tree(g), cfg)
                         for g in (grads_j, grads_32))
    tol = TOL[dtype]

    def err(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    scale = float(np.abs(out_32).max())
    assert err(out_p, out_j) <= tol * scale
    assert err(out_p, out_32) <= 2 * err(out_j, out_32)
    assert loss_p == pytest.approx(float(loss_j), rel=tol)
    tree = max(float(t.abs().max()) for t in grads_32.values())
    assert set(grads_p) == set(grads_j)
    for n in grads_j:
        assert err(grads_p[n], grads_j[n]) <= tol * tree, n
    worst = [max(err(grads_p[n], grads_32[n]) for n in grads_j),
             max(err(grads_j[n], grads_32[n]) for n in grads_j)]
    assert worst[0] <= 2 * worst[1], worst


def test_masters_stay_float32_after_a_step(tmp_path, sample_graphs):
    tp = _trainer(tmp_path, _cfg(port_model.ModelConfig,
                                 **CONFIGS["light_set2set_bn"]), "bfloat16")
    before = {n: p.detach().clone() for n, p in tp.model.named_parameters()}
    tp.model.train()
    loss = tp.train_step((_port_batch(SMILES_SET),))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    moved = 0
    for n, p in tp.model.named_parameters():
        assert p.dtype == torch.float32, n
        moved += int(not torch.equal(p.detach(), before[n]))
    assert moved == len(before)
    for n, b in tp.model.named_buffers():
        assert b.dtype == torch.float32, n
    state = tp.optimizer.state_dict()["state"]
    assert all(v.dtype == torch.float32 for s in state.values()
               for v in s.values() if torch.is_tensor(v) and v.ndim)


def test_two_epochs_match_jax(tmp_path):
    """JAX make_trainer and the port's at --dtype bfloat16 on 100 demo
    molecules, from the same weights: per-epoch losses."""
    root = _raw_copy(tmp_path / "data", "demo", 100)
    args = dict(TRAIN_ARGS, dataset_root=str(root), dtype="bfloat16")
    args, ds, kind = jax_datasets.auto_dataset(args)
    tj = jax_trainer.make_trainer(args, ds, kind,
                                  work_dir=str(tmp_path / "jax"))
    pds = port_datasets.MolDataset(str(root), "demo")
    tp = port_trainer.make_trainer(args, pds, kind,
                                   work_dir=str(tmp_path / "port"),
                                   device="cpu")
    tp.model.load_state_dict(convert.state_dict_from_jax(
        _np_tree(tj.state.params), tp.model.cfg))
    rec_j, rec_p = _record_losses(tj, True), _record_losses(tp, False)
    tj.train()
    tp.train()
    assert len(rec_j["trn"]) == len(rec_p["trn"]) == 2
    np.testing.assert_allclose(rec_p["trn"], rec_j["trn"], rtol=2e-2)
    np.testing.assert_allclose(rec_p["val"], rec_j["val"], rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tp.model.parameters())


def test_cli_dtype(tmp_path):
    """``--dtype bfloat16`` trains through the CLI; an unknown name
    raises."""
    root = _raw_copy(tmp_path / "data", "demo", 40)
    argv = ["--dataset", "demo", "--dataset_root", str(root), "--loss",
            "bcel", "--epochs", "1", "--e_dim", "16", "--hid_dim_alpha",
            "1", "--mol_block", "_TripletMessage", "--platform", "cpu",
            "--work_dir", str(tmp_path)]
    tp = run.main(argv + ["--dtype", "bfloat16"])
    assert tp.compute_dtype == torch.bfloat16
    last = (tp.log_save_dir / "log.txt").read_text().strip().splitlines()[-1]
    loss = ast.literal_eval(last.split("|")[0])
    assert np.isfinite([loss["testloss"], loss["valloss"]]).all()
    with pytest.raises(ValueError, match="unknown --dtype"):
        run.main(argv + ["--dtype", "int8"])
