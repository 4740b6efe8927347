"""Attention visualization: the port's ``Visualizer`` (``viz/attention.py``)
against the JAX package's, on the CPU, from one JAX checkpoint converted
to the port.  Each mode's per-atom weights (``hidden_node``,
``lapool_attention``, ``set2set_attention``, ``triplet_attention`` per
head) agree within 1e-5 (float32 sums in other orders; the weights are
min-max normalised or softmax-normalised, so of order one); PNGs are
written; the CLI renders from a port ``.pt`` run and from a JAX
``.ckpt`` run; a mode the model lacks raises as in JAX."""
import numpy as np
import pytest

from glam_tpu.chem.featurize import smiles_to_arrays
from glam_tpu.data.batching import GraphLoader as JaxLoader
from glam_tpu.data.graph import GraphArrays as JaxGraph
from glam_tpu.serve import Predictor as JaxPredictor
from glam_tpu.viz import attention as jax_viz
from glam_tpu.viz import layout2d as jax_layout
from glam_tpu_torch.chem.smiles import parse_smiles
from glam_tpu_torch.serve import Predictor
from glam_tpu_torch.viz import attention as port_viz
from glam_tpu_torch.viz import layout2d as port_layout
from test_torch_port_serve import _port_ckpt_from_jax, _write_jax_ckpt

SMILES = ["CCO", "c1ccccc1O", "CC(=O)Oc1ccccc1C(=O)O",
          "CN1C=NC2=C1C(=O)N(C)C2=O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "C"]
MODELS = {
    "triplet": (dict(mol_block="_TripletMessage", mol_readout="GlobalLAPool"),
                ("hidden_node", "lapool_attention", "triplet_attention")),
    "set2set": (dict(mol_block="_TripletMessageLight", mol_readout="Set2Set",
                     graph_norm="_BatchNorm"),
                ("hidden_node", "set2set_attention")),
}


def _jax_weights(pred, mode, smiles):
    shim = jax_viz._CkptShim(pred)
    # the JAX Visualizer reads the flat args; these checkpoints carry the
    # model's names only in model_cfg
    shim.args.update(pred.args.get("model_cfg", {}))
    viz = jax_viz.Visualizer(shim, vis_content=mode)
    variables = {"params": pred.params}
    if pred.batch_stats:
        variables["batch_stats"] = pred.batch_stats
    out = []
    for smi in smiles:
        x, snd, rcv, e = smiles_to_arrays(smi)
        g = JaxGraph(nodes=x, edges=e, senders=snd, receivers=rcv,
                     y=np.zeros(1, np.float32), smi=smi)
        batch = next(iter(JaxLoader([g], 1, 1)))
        _, steps = pred.model.apply(variables, batch, True, return_nodes=True)
        out.append(viz._weights(np.asarray(steps[-1])[:x.shape[0]],
                                graph=(e, snd, rcv)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    sample_graphs = request.getfixturevalue("sample_graphs")
    out = {}
    for name, (kw, _) in MODELS.items():
        tmp = tmp_path_factory.mktemp(name)
        _write_jax_ckpt(tmp / "jax", sample_graphs, 32, **kw)
        _port_ckpt_from_jax(tmp / "jax", tmp / "port")
        out[name] = tmp
    return out


@pytest.mark.parametrize("name, mode", [(n, m) for n, (_, ms) in
                                        MODELS.items() for m in ms])
def test_weights_match_jax(runs, name, mode):
    pj = JaxPredictor.from_checkpoint(runs[name] / "jax")
    want = _jax_weights(pj, mode, SMILES)
    for which, d in (("best_save.pt", "port"), ("best_save.ckpt", "jax")):
        pt = Predictor.from_checkpoint(runs[name] / d, which=which,
                                       device="cpu")
        got = port_viz.Visualizer(pt, mode).weights(SMILES)
        assert len(got) == len(want)
        for g, w, smi in zip(got, want, SMILES):
            assert g.shape == np.shape(w), smi
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{mode} {smi}")


def test_visualize_writes_pngs(runs, tmp_path):
    pt = Predictor.from_checkpoint(runs["triplet"] / "port", device="cpu")
    paths = port_viz.Visualizer(pt, "triplet_attention").visualize(
        SMILES[:2], str(tmp_path / "heads"))
    assert len(paths) == 2 * 3                       # one PNG per head
    paths += port_viz.Visualizer(pt, "hidden_node").visualize(
        SMILES[:2], str(tmp_path / "hidden"))
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("d, which", [("port", None), ("jax", None),
                                      ("jax", "best_save.ckpt")])
def test_cli(runs, tmp_path, capsys, d, which):
    argv = ["--ckpt", str(runs["set2set"] / d), "--smiles", "CCO",
            "c1ccccc1", "--mode", "set2set_attention", "--out_dir",
            str(tmp_path), "--device", "cpu"]
    port_viz.main(argv + (["--which", which] if which else []))
    printed = capsys.readouterr().out.split()
    assert printed == [str(tmp_path / f"attention_{i}.png") for i in (0, 1)]


def test_cli_defaults_to_cuda(runs):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_viz.main(["--ckpt", str(runs["set2set"] / "port"), "--smiles",
                       "CCO"])


@pytest.mark.parametrize("name, mode, match", [
    ("set2set", "lapool_attention", "GlobalLAPool"),
    ("triplet", "set2set_attention", "Set2Set"),
    ("set2set", "triplet_attention", "_TripletMessage"),
    ("set2set", "nope", "Unknown content")])
def test_mode_errors(runs, name, mode, match):
    pt = Predictor.from_checkpoint(runs[name] / "port", device="cpu")
    with pytest.raises(ValueError, match=match):
        port_viz.Visualizer(pt, mode)


def test_layout_and_numpy_reductions_match_jax():
    rng = np.random.RandomState(0)
    for smi in SMILES:
        np.testing.assert_array_equal(
            port_layout.layout2d(parse_smiles(smi)),
            jax_layout.layout2d(jax_viz.parse_smiles(smi)))
        np.testing.assert_array_equal(
            port_viz.spring_layout(parse_smiles(smi), iterations=20),
            jax_viz.spring_layout(jax_viz.parse_smiles(smi), iterations=20))
    emb = rng.randn(7, 5).astype(np.float32)
    np.testing.assert_array_equal(port_viz.node_weights_from_embeddings(emb),
                                  jax_viz.node_weights_from_embeddings(emb))
