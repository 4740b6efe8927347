"""Serving parity: one JAX checkpoint, written the way the JAX trainer
writes ``best_save.ckpt`` (from init params, untrained; BatchNorm
statistics, where the model has them, after one training forward), is
served by the JAX ``Predictor`` and, decoded with flax, converted and
saved as ``best_save.pt``, by the port's ``Predictor`` on the CPU.
Predictions agree, NaN rows included."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from conftest import SMILES_SET
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.nn import model as jax_model
from glam_tpu.serve import Predictor as JaxPredictor
from glam_tpu_torch import convert
from glam_tpu_torch.nn import model as port_model
from glam_tpu_torch.serve import Predictor, save_checkpoint

REQUEST = (SMILES_SET[:3] + ["C1CC"] + SMILES_SET[3:] + ["xyz"]
           + ["CC(C)Cc1ccc(cc1)C(C)C(=O)O",
              "O=C(O)c1ccccc1O", "CCN(CC)CC"])


def _write_jax_ckpt(run_dir, sample_graphs, max_nodes, **model_kw):
    """A JAX checkpoint of the flagship model, or of ``model_kw``'s; with
    a ``_BatchNorm``, its running statistics are those after one
    training-mode forward, not the initial zeros and ones."""
    kw = dict(mol_block="_TripletMessage", hid_dim_alpha=2, e_dim=32,
              message_steps=2, max_nodes=max_nodes)
    kw.update(model_kw)
    cfg = jax_model.ModelConfig(**kw)
    args = {"dataset": "demo", "task": "binary_nan_bce", "num_tasks": 1,
            "out_dim": 1, "model_cfg": dataclasses.asdict(cfg)}
    batch = next(iter(JaxLoader(sample_graphs, 6, 1)))
    model = jax_model.Architecture(cfg)
    variables = model.init(jax.random.PRNGKey(5), batch, True)
    params, stats = variables["params"], variables.get("batch_stats", {})
    if stats:
        _, upd = model.apply(variables, batch, False, mutable=[
            "batch_stats"], rngs={"dropout": jax.random.PRNGKey(6)})
        stats = upd["batch_stats"]
    payload = {"args": json.dumps(args), "records": json.dumps({}),
               "params": serialization.to_bytes(params),
               "batch_stats": serialization.to_bytes(stats)}
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "best_save.ckpt", "wb") as f:
        f.write(serialization.msgpack_serialize(payload))


def _port_ckpt_from_jax(jax_dir, port_dir):
    with open(jax_dir / "best_save.ckpt", "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    args = json.loads(payload["args"])
    params = serialization.msgpack_restore(payload["params"])
    stats = serialization.msgpack_restore(payload["batch_stats"])
    cfg = port_model.ModelConfig(**args["model_cfg"])
    model = port_model.Architecture(cfg)
    model.load_state_dict(convert.state_dict_from_jax(params, cfg, stats))
    return save_checkpoint(port_dir, model, args)


class TestPredictorParity:
    # max_nodes 8 pins budgets too small for these batches, so both
    # predictors take the input-derived fallback budgets
    @pytest.mark.parametrize("max_nodes", [32, 8])
    def test_predictions_match(self, tmp_path, sample_graphs, max_nodes):
        _write_jax_ckpt(tmp_path / "jax", sample_graphs, max_nodes)
        _port_ckpt_from_jax(tmp_path / "jax", tmp_path / "port")
        pj = JaxPredictor.from_checkpoint(tmp_path / "jax", batch_size=4)
        pt = Predictor.from_checkpoint(tmp_path / "port", batch_size=4,
                                       device="cpu")
        assert (pt.node_budget, pt.edge_budget) == (pj._node_budget,
                                                    pj._edge_budget)
        valid = [g for g in pt.featurize(REQUEST) if g is not None]
        pinned = {b.num_nodes for b in pt.batches(valid)} == {pt.node_budget}
        assert pinned == (max_nodes == 32)
        for fn in ("predict_smiles", "predict_scores"):
            want = getattr(pj, fn)(REQUEST)
            got = getattr(pt, fn)(REQUEST)
            assert got.shape == want.shape == (len(REQUEST), 1)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            assert np.isnan(got[[3, 7]]).all()
            assert np.isfinite(np.delete(got, [3, 7], axis=0)).all()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5,
                                       err_msg=fn)

    @pytest.mark.parametrize("model_kw", [
        dict(mol_block="_TripletMessageLight", mol_readout="Set2Set",
             graph_norm="_BatchNorm", flat_norm="_BatchNorm",
             end_norm="_LayerNorm"),
        dict(mol_block="_GATConv", mol_readout="GlobalLAPool",
             pre_norm="_LayerNorm", graph_norm="_GraphSizeNorm",
             end_norm="_BatchNorm")])
    def test_library_checkpoint_predictions_match(self, tmp_path,
                                                  sample_graphs, model_kw):
        """A checkpoint of the layer library, BatchNorm running statistics
        included, serves as the JAX Predictor serves it."""
        _write_jax_ckpt(tmp_path / "jax", sample_graphs, 32, **model_kw)
        path = _port_ckpt_from_jax(tmp_path / "jax", tmp_path / "port")
        saved = torch.load(path, weights_only=True)["state_dict"]
        moved = [k for k in saved if k.endswith(".mean")]
        assert moved and all(saved[k].abs().max() > 0 for k in moved)
        pj = JaxPredictor.from_checkpoint(tmp_path / "jax", batch_size=4)
        pt = Predictor.from_checkpoint(tmp_path / "port", batch_size=4,
                                       device="cpu")
        want, got = pj.predict_smiles(REQUEST), pt.predict_smiles(REQUEST)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)

    def test_all_invalid_and_load_without_forward(self, tmp_path,
                                                  sample_graphs):
        _write_jax_ckpt(tmp_path / "jax", sample_graphs, 32)
        path = _port_ckpt_from_jax(tmp_path / "jax", tmp_path / "port")
        calls = []
        handle = torch.nn.modules.module.register_module_forward_hook(
            lambda *a: calls.append(1))
        try:
            pt = Predictor.from_checkpoint(path.parent, device="cpu")
        finally:
            handle.remove()
        assert calls == []               # loading runs no forward pass
        out = pt.predict_smiles(["xyz", "C1CC"])
        assert out.shape == (2, 1) and np.isnan(out).all()
        assert pt.predict_smiles([]).shape == (0, 1)


class TestDevice:
    def test_cuda_without_card_raises(self, tmp_path, sample_graphs):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = port_model.ModelConfig(mol_block="_TripletMessage", e_dim=16,
                                     hid_dim_alpha=1, message_steps=1)
        model = port_model.Architecture(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(model, {}, device="cuda")
        path = save_checkpoint(tmp_path, model, {})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor.from_checkpoint(path.parent)   # cuda by default
