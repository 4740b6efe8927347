"""The port's PASP builder (``chem/fingerprints.py``,
``data/perturb_builder.py``, no pandas) against the JAX package's, on
the CPU: fingerprints bit for bit; the candidates, the rows and the
written CSV byte for byte, on a homologous corpus and on physprop's
first 1,500 molecules; the CLI; the port's loaders read what it wrote."""
import csv
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from glam_tpu.chem import fingerprints as jax_fp
from glam_tpu.data import perturb_builder as jax_builder
from glam_tpu_torch.chem import fingerprints as port_fp
from glam_tpu_torch.data import perturb as port_perturb
from glam_tpu_torch.data import perturb_builder as port_builder
from glam_tpu_torch.data.datasets import read_csv
from test_perturb_builder import _homologous_corpus

PHYSPROP = (Path(__file__).resolve().parents[1] / "datasets" / "physprop"
            / "raw" / "physprop_perturb.csv")


def _physprop(n):
    df = pd.read_csv(PHYSPROP)[["SMILES", "LogP"]]
    return df.iloc[:n].reset_index(drop=True)


def test_fingerprints_bit_exact():
    smis = list(_homologous_corpus()["SMILES"]) + ["((((", "C1CC", ""]
    smis += list(_physprop(300)["SMILES"])
    for radius, n_bits in ((2, 2048), (3, 1024)):
        got = port_fp.fingerprint_matrix(smis, radius, n_bits)
        want = jax_fp.fingerprint_matrix(smis, radius, n_bits)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert port_fp.fingerprint("((((") is None
    np.testing.assert_array_equal(port_fp.tanimoto_row(got, 3),
                                  jax_fp.tanimoto_row(want, 3))


@pytest.mark.parametrize("corpus", ["homologous", "physprop1500"])
def test_builder_matches_jax(tmp_path, corpus):
    df = (_homologous_corpus() if corpus == "homologous"
          else _physprop(1500))
    kw = dict(thre=0.5, seed=3) if corpus == "homologous" else {}
    src = tmp_path / "in.csv"
    df.to_csv(src, index=False)
    _, table = read_csv(src)
    smis, vals = list(df["SMILES"]), df["LogP"].to_numpy()
    thre = kw.get("thre", 0.2)
    assert (port_builder.find_perturb_candidates(smis, vals, thre)
            == jax_builder.find_perturb_candidates(smis, vals, thre))
    want = jax_builder.build_perturbed_dataset(df, str(tmp_path / "j.csv"),
                                               **kw)
    rows = port_builder.build_perturbed_dataset(table, str(tmp_path / "p.csv"),
                                                **kw)
    assert len(rows) == len(want)
    assert ((tmp_path / "p.csv").read_bytes()
            == (tmp_path / "j.csv").read_bytes())
    labels = [r["Label"] for r in rows]
    assert labels.count("test") > 0 and set(labels) == {"test", "train",
                                                        "val"}


def test_cli_and_loaders(tmp_path, capsys):
    """``main`` takes the JAX flags; ``data.perturb`` loads the result as
    physprop_perturb."""
    src = tmp_path / "in.csv"
    _homologous_corpus().rename(columns={"SMILES": "smi", "LogP": "y"}) \
        .to_csv(src, index=False)
    root = tmp_path / "pp"
    (root / "raw").mkdir(parents=True)
    out = root / "raw" / "physprop_perturb.csv"
    port_builder.main([str(src), str(out), "--smiles_col", "smi",
                       "--value_col", "y", "--thre", "0.5", "--seed", "3"])
    printed = capsys.readouterr().out
    assert printed.startswith(f"wrote {out}") and "'test'" in printed
    with open(out, newline="") as f:
        assert next(csv.reader(f)) == port_builder.COLUMNS
    ds = port_perturb.PerturbationDataset(str(root), "physprop_perturb")
    assert len(ds.test) > 0 and len(ds.train) > 0
    M, M_prime, Q, Q_prime = port_perturb.perturb_test(
        str(root), "physprop_perturb", 1)
    assert len(M) == len(M_prime) == len(Q) == len(Q_prime) == len(ds.test)


def test_no_candidates_raises():
    with pytest.raises(ValueError, match="no molecule"):
        port_builder.build_perturbed_dataset(
            {"SMILES": ["CCO", "c1ccc2ccccc2c1"], "LogP": ["1.0", "3.0"]})
