"""JAX checkpoints served by the port on the CPU.

``utils/msgpack.py`` decodes what flax writes exactly as flax's
``msgpack_restore`` does (equal values, equal dtypes; bfloat16 as
float32, which holds every bfloat16 exactly).  A ``best_save.ckpt``
written by the JAX CLI (``glam_tpu.run``, 1 epoch on 20 demo molecules;
again with BatchNorm, whose running statistics it holds; a DDI and a DTI
pair run) is served by ``Predictor`` / ``PairPredictor.from_checkpoint(
..., which="best_save.ckpt", device="cpu")`` as the JAX package's
predictors serve it: scores within rtol 1e-5 + atol 1e-5 (float32 sums
in other orders), NaN rows alike.  The two committed fixtures
(``tests/data/jax_ckpt``, written by ``scripts/make_jax_ckpt_fixtures.py``)
reproduce the JAX scores and attention weights stored beside them within
1e-4, the tolerance ``chip_smoke.py`` holds the card to."""
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from glam_tpu import run as jax_run
from glam_tpu.serve import PairPredictor as JaxPairPredictor
from glam_tpu.serve import Predictor as JaxPredictor
from glam_tpu_torch import convert
from glam_tpu_torch.data import pair_datasets as port_pairs
from glam_tpu_torch.serve import (EnsemblePredictor, PairPredictor,
                                  Predictor)
from glam_tpu_torch.utils import msgpack

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "datasets"
FIXTURES = ROOT / "tests" / "data" / "jax_ckpt"
SMALL = ["--epochs", "1", "--e_dim", "32", "--hid_dim_alpha", "2",
         "--message_steps", "2", "--seed", "3", "--platform", "cpu"]
REQUEST = ["CCO", "C1CC", "c1ccccc1", "xyz", "CC(=O)Oc1ccccc1C(=O)O", "C",
           "N1CC2", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C(O)c1ccccc1O"]


def _same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        g = np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    else:
        assert type(got) is type(want) and got == want


# ------------------------------------------------------------ the decoder
def test_decoder_matches_flax_on_every_type(monkeypatch):
    import flax.serialization as fs
    tree = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
            "i64": np.arange(-3, 3, dtype=np.int64),
            "u8": np.zeros(0, np.uint8),
            "bf16": np.asarray(jnp.linspace(-2, 3, 7, dtype=jnp.bfloat16)),
            "f16": np.ones((2, 2), np.float16),
            "bool": np.asarray([True, False]),
            "scalars": {"i": np.int32(-7), "f": np.float64(2.5)},
            "plain": [0, 1, -1, 127, 128, -33, 255, 65536, -70000, 2 ** 40,
                      -(2 ** 40), 1.25, None, True, False, "", "é" * 40,
                      "x" * 300, b"\x00\x01", b"y" * 70000, complex(1, -2)],
            "deep": {str(i): {"k": i} for i in range(20)}}
    data = serialization.msgpack_serialize(tree)
    _same(msgpack.unpackb(data), serialization.msgpack_restore(data))
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    big = {"w": np.arange(100, dtype=np.float32).reshape(4, 25)}
    data = serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    _same(msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_decoder_matches_flax_on_the_fixtures():
    for name in ("flagship", "light_set2set_bn"):
        raw = (FIXTURES / name / "best_save.ckpt").read_bytes()
        got, want = msgpack.unpackb(raw), serialization.msgpack_restore(raw)
        assert got.keys() == want.keys() == {"args", "records", "params",
                                             "batch_stats"}
        for key in ("params", "batch_stats"):
            _same(msgpack.unpackb(got[key]),
                  serialization.msgpack_restore(want[key]))


@pytest.mark.parametrize("data, match", [
    (b"\xd4\x07\x00", "ext type 7"), (b"\xc1", "reserved"),
    (b"\x92\x01", "truncated"), (b"\x01\x02", "past the msgpack")])
def test_decoder_raises(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(data)


# ------------------------------------------- JAX CLI checkpoints, served
def _jax_run(tmp_path, dataset, root, flags):
    jax_run.main(["--dataset", dataset, "--dataset_root", str(root),
                  "--work_dir", str(tmp_path)] + SMALL + flags)
    (run_dir,) = [p for p in (tmp_path / f"log_{dataset}").iterdir()
                  if p.is_dir()]
    return run_dir


def _demo20(tmp_path):
    root = tmp_path / "demo"
    (root / "raw").mkdir(parents=True)
    lines = (DATA / "demo" / "raw" / "demo.csv").read_text().splitlines()
    (root / "raw" / "demo.csv").write_text("\n".join(lines[:21]) + "\n")
    return root


@pytest.mark.parametrize("flags", [
    ["--mol_block", "_TripletMessage", "--loss", "bcel"],
    ["--mol_block", "_TripletMessageLight", "--mol_readout", "Set2Set",
     "--graph_norm", "_BatchNorm", "--flat_norm", "_BatchNorm",
     "--loss", "bcel"]], ids=["flagship", "batchnorm"])
def test_jax_cli_checkpoint_served(tmp_path, flags):
    run_dir = _jax_run(tmp_path, "demo", _demo20(tmp_path), flags)
    jp = JaxPredictor.from_checkpoint(run_dir, batch_size=4)
    pt = Predictor.from_checkpoint(run_dir, which="best_save.ckpt",
                                   batch_size=4, device="cpu")
    args, state = convert.load_jax_checkpoint(run_dir / "best_save.ckpt")
    assert args == jp.args and convert.pair_kind(args) is None
    if "_BatchNorm" in flags:
        stats = [k for k in state if k.endswith(".mean")]
        assert stats and all(state[k].abs().max() > 0 for k in stats)
    for fn in ("predict_smiles", "predict_scores"):
        want, got = getattr(jp, fn)(REQUEST), getattr(pt, fn)(REQUEST)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[[1, 3, 6]]).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="single-graph"):
        PairPredictor.from_checkpoint(run_dir, which="best_save.ckpt",
                                      device="cpu")


def test_jax_ddi_checkpoint_served(tmp_path):
    root = tmp_path / "ddi"
    shutil.copytree(DATA / "ddi_demo" / "raw", root / "raw")
    run_dir = _jax_run(tmp_path, "drugbank_caster", root,
                       ["--mol_block", "_TripletMessage"])
    ds = port_pairs.DDIDataset(str(root))
    pairs = [(g1.smi, g2.smi) for g1, g2 in ds.test][:24]
    pairs += [("xyz", "CCO"), ("CCO", "C1CC")]
    jp = JaxPairPredictor.from_checkpoint(run_dir, batch_size=8)
    pt = PairPredictor.from_checkpoint(run_dir, which="best_save.ckpt",
                                       batch_size=8, device="cpu")
    assert not pt.hetero
    want, got = jp.predict_scores(pairs), pt.predict_scores(pairs)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-2:]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="PairPredictor"):
        Predictor.from_checkpoint(run_dir, which="best_save.ckpt",
                                  device="cpu")


def test_jax_dti_checkpoint_served(tmp_path):
    root = tmp_path / "dti"
    shutil.copytree(DATA / "dti_demo" / "raw", root / "raw")
    run_dir = _jax_run(tmp_path, "bindingdb_c", root,
                       ["--mol_block", "_TripletMessage", "--pro_block",
                        "_GATConv"])
    ds = port_pairs.BindingDBDataset(str(root))
    pairs = [(g1.smi, g2.smi) for g1, g2 in ds.test][:24]
    pairs += [("CCO", "NOSUCHPROTEIN"), ("xyz", pairs[0][1])]
    jp = JaxPairPredictor.from_checkpoint(run_dir, batch_size=8,
                                          contact_maps=ds.contact_maps)
    pt = PairPredictor.from_checkpoint(run_dir, which="best_save.ckpt",
                                       contact_maps=ds.contact_maps,
                                       batch_size=8, device="cpu")
    assert pt.hetero
    want, got = jp.predict_scores(pairs), pt.predict_scores(pairs)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-2:]).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the committed fixtures
@pytest.mark.parametrize("name", ["flagship", "light_set2set_bn"])
def test_fixture_reproduces_jax_scores(name):
    exp = np.load(FIXTURES / name / "expected.npz")
    pt = Predictor.from_checkpoint(FIXTURES / name, which="best_save.ckpt",
                                   batch_size=128, device="cpu")
    got = pt.predict_scores(list(exp["smiles"]))
    want = exp["scores"]
    assert got.shape == want.shape == (len(exp["smiles"]), 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).sum() == 3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ensemble_over_jax_and_port_runs(tmp_path):
    """``EnsemblePredictor.from_runs`` ranks JAX runs by their logs and
    serves them through ``Predictor``: the mean of the two fixtures."""
    logs = tmp_path / "log_demo"
    for i, name in enumerate(("flagship", "light_set2set_bn")):
        shutil.copytree(FIXTURES / name, logs / f"run{i}_seed_0")
    ens = EnsemblePredictor.from_runs(logs, n=2, device="cpu")
    assert len(ens.predictors) == 2
    smis = list(np.load(FIXTURES / "flagship" / "expected.npz")["smiles"])
    want = np.mean([np.load(FIXTURES / n / "expected.npz")["scores"]
                    for n in ("flagship", "light_set2set_bn")], axis=0)
    got = ens.predict_scores(smis)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    args = json.loads(msgpack.unpackb(
        (FIXTURES / "flagship" / "best_save.ckpt").read_bytes())["args"])
    assert args["model_cfg"]["e_dim"] == 1024
