#!/usr/bin/env python3
"""Write the JAX checkpoint fixtures the port serves on the card.

    JAX_PLATFORMS=cpu python scripts/make_jax_ckpt_fixtures.py

Imports JAX and the JAX package (``glam_tpu``) and runs on the CPU.  For
each fixture it trains one epoch of ``python -m glam_tpu.run`` on
``datasets/demo`` (seed 0, ``--loss bcel``) at full width (hid 60 = 15 x
``--hid_dim_alpha 4``, 3 message steps, e_dim 1024) in a scratch
directory, and writes ``tests/data/jax_ckpt/<name>/``:

  best_save.ckpt  the JAX trainer's checkpoint (flax msgpack)
  log.txt         the run log's last two lines (its config and its final
                  result line), all ``automl.summary.read_logs`` reads
  expected.npz    ``smiles`` and ``scores``: the JAX ``Predictor``'s
                  ``predict_scores`` on demo SMILES 0-127 and the smoke's
                  request with invalid SMILES (NaN rows there);
                  ``viz_smiles`` and ``viz_<mode>_<i>``: the JAX
                  ``Visualizer``'s per-atom weights on 8 demo SMILES in
                  every mode the model allows

Fixtures:
  flagship          _TripletMessage (H = 3), GlobalPool5, _PairNorm
                    (the JAX CLI's defaults otherwise)
  light_set2set_bn  _TripletMessageLight + Set2Set, _BatchNorm (graph and
                    flat), so the checkpoint holds ``batch_stats``

The runs use relative paths in a scratch directory and the archive is
written with fixed timestamps, so the files come out byte for byte the
same on every run on the same JAX version.
"""
from __future__ import annotations

import contextlib
import io
import os
import shutil
import sys
import tempfile
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "jax_ckpt"
COMMON = ["--dataset", "demo", "--dataset_root", "datasets/demo",
          "--epochs", "1", "--loss", "bcel", "--seed", "0",
          "--hid_dim_alpha", "4", "--e_dim", "1024", "--message_steps", "3",
          "--work_dir", ".", "--platform", "cpu"]
FIXTURES = {
    "flagship": (["--mol_block", "_TripletMessage", "--mol_readout",
                  "GlobalPool5"], ("hidden_node", "triplet_attention")),
    "light_set2set_bn": (["--mol_block", "_TripletMessageLight",
                          "--mol_readout", "Set2Set", "--graph_norm",
                          "_BatchNorm", "--flat_norm", "_BatchNorm"],
                         ("hidden_node", "set2set_attention")),
}
# chip_smoke.py's serving request with invalid SMILES
WITH_INVALID = ["CCO", "C1CC", "c1ccccc1", "xyz", "CC(=O)Oc1ccccc1C(=O)O",
                "C", "N1CC2"]
N_SCORED, N_VIZ = 128, 8


def demo_smiles():
    import csv
    with open(ROOT / "datasets" / "demo" / "raw" / "demo.csv",
              newline="") as f:
        return [r["smiles"] for r in csv.DictReader(f)]


def write_npz(path: Path, arrays) -> None:
    """``np.savez`` with fixed archive timestamps."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arr),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            zf.writestr(info, buf.getvalue())


def viz_weights(pred, mode, smiles):
    """The JAX ``Visualizer``'s weights, molecule by molecule, as its
    ``visualize`` computes them before drawing."""
    from glam_tpu.chem.featurize import smiles_to_arrays
    from glam_tpu.data.batching import GraphLoader
    from glam_tpu.data.graph import GraphArrays
    from glam_tpu.viz.attention import Visualizer, _CkptShim

    viz = Visualizer(_CkptShim(pred), vis_content=mode)
    variables = {"params": pred.params}
    if pred.batch_stats:
        variables["batch_stats"] = pred.batch_stats
    out = []
    for smi in smiles:
        x, snd, rcv, e = smiles_to_arrays(smi)
        g = GraphArrays(nodes=x, edges=e, senders=snd, receivers=rcv,
                        y=np.zeros(1, np.float32), smi=smi)
        batch = next(iter(GraphLoader([g], 1, 1)))
        _, steps = pred.model.apply(variables, batch, True,
                                    return_nodes=True)
        emb = np.asarray(steps[-1])[:x.shape[0]]
        out.append(np.asarray(viz._weights(emb, graph=(e, snd, rcv)),
                              np.float32))
    return out


def make(name, flags, modes, demo) -> None:
    from glam_tpu import run
    from glam_tpu.serve import Predictor

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "datasets" / "demo" / "raw",
                        Path(tmp) / "datasets" / "demo" / "raw")
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                run.main(COMMON + flags)
            (run_dir,) = [p for p in Path(tmp, "log_demo").iterdir()
                          if p.is_dir()]
            dest = OUT / name
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(run_dir / "best_save.ckpt",
                            dest / "best_save.ckpt")
            lines = (run_dir / "log.txt").read_text().strip().split("\n")
            (dest / "log.txt").write_text("\n".join(lines[-2:]) + "\n")
        finally:
            os.chdir(cwd)
    pred = Predictor.from_checkpoint(dest, which="best_save.ckpt",
                                     batch_size=128)
    smiles = demo[:N_SCORED] + WITH_INVALID
    arrays = {"smiles": np.asarray(smiles),
              "scores": pred.predict_scores(smiles).astype(np.float32),
              "viz_smiles": np.asarray(demo[:N_VIZ])}
    for mode in modes:
        for i, w in enumerate(viz_weights(pred, mode, demo[:N_VIZ])):
            arrays[f"viz_{mode}_{i}"] = w
    write_npz(dest / "expected.npz", arrays)
    sizes = {p.name: p.stat().st_size for p in sorted(dest.iterdir())}
    print(f"{name}: {sizes}")


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    demo = demo_smiles()
    names = sys.argv[1:] or list(FIXTURES)
    for name in names:
        flags, modes = FIXTURES[name]
        make(name, flags, modes, demo)


if __name__ == "__main__":
    main()
