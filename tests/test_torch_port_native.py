"""The port's native featurizer (``glam_tpu_torch/chem/native.py`` over
``csrc/glam_native.cpp``, built here with ``g++``) against the port's
Python featurizer: byte for byte (dtype, shape and bytes of every array)
on the JAX package's native-test molecules, the valence-sanitization
rejects and accepts, and the first 200 demo SMILES; both raise on the
same inputs.  The C++ source is a byte-identical copy of the JAX
package's.  Exact comparison, no tolerance."""
import csv
from pathlib import Path

import pytest

from glam_tpu_torch.chem import native
from glam_tpu_torch.chem.featurize import smiles_to_arrays
from glam_tpu_torch.data import datasets as port_datasets
from glam_tpu_torch.ops.kernels import build

ROOT = Path(__file__).resolve().parents[1]
# tests/test_native.py's MOLECULES and test_chem.py's
# TestValenceSanitization lists
MOLECULES = [
    "CCO", "c1ccccc1", "C1=CC=CC=C1", "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "c1cc[nH]c1", "[NH4+].[Cl-]",
    "C#N", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "O=C1C=CC(=O)C=C1",
    "[Na+].CCOc1ccc2ccccc2c1C(=O)N[C@H]3[C@H]4SC(C)(C)[C@@H](N4C3=O)"
    "C([O-])=O",
    "C1=CC2=CC=CC=CC2=C1", "c1ccc2cccc2cc1", "OC1=CC2=CC=CC=CC2=C1",
    "C1=CC2=CC=CC12",
]
REJECTS = ["C(C)(C)(C)(C)C", "[CH5]", "FF(F)F", "CN(=O)=O", "O=Cl(=O)(=O)O",
           "O=I(=O)c1ccccc1", "C[Na]C", "OO(O)O", "C=[CH3]"]
ACCEPTS = ["CCO", "c1ccccc1", "C1=CC=CN1", "c1cc[nH]c1", "[NH4+]", "[BH4-]",
           "C[N+](C)(C)C", "C[N+](=O)[O-]", "OS(=O)(=O)O", "FS(F)(F)(F)(F)F",
           "ClP(Cl)(Cl)(Cl)Cl", "[O-][Cl+3]([O-])([O-])[O-]", "[O-]c1ccccc1",
           "[Na+].[Cl-]", "[2H]OC", "[Fe+2]", "C[Si](C)(C)C", "[H][H]",
           "B(O)(O)O", "c1ccc2ccccc2c1", "C1=CC2=CC=CC2=C1"]


def _demo(n):
    with open(ROOT / "datasets" / "demo" / "raw" / "demo.csv",
              newline="") as f:
        return [r["smiles"] for r, _ in zip(csv.DictReader(f), range(n))]


def _outcome(fn, smi):
    try:
        return fn(smi)
    except ValueError:
        return None


def _assert_same(smi):
    want = _outcome(smiles_to_arrays, smi)
    got = _outcome(native.smiles_to_arrays_native, smi)
    if want is None:
        assert got is None, f"{smi!r}: native accepts what Python rejects"
        return
    assert got is not None, f"{smi!r}: native rejects what Python accepts"
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, smi
        assert g.tobytes() == w.tobytes(), smi


def test_source_is_the_jax_packages_copy():
    assert ((ROOT / "glam_tpu_torch" / "csrc" / "glam_native.cpp")
            .read_bytes() == (ROOT / "native" / "csrc" / "glam_native.cpp")
            .read_bytes())


@pytest.mark.parametrize("smi", MOLECULES)
def test_molecules_byte_exact(smi):
    _assert_same(smi)


@pytest.mark.parametrize("group", ["rejects", "accepts"])
def test_valence_sanitization_agrees(group):
    smis = REJECTS if group == "rejects" else ACCEPTS
    for smi in smis:
        _assert_same(smi)
    if group == "rejects":
        for smi in smis:
            with pytest.raises(ValueError):
                native.smiles_to_arrays_native(smi)


def test_demo_corpus_byte_exact():
    for smi in _demo(200):
        _assert_same(smi)


def test_invalid_raises_and_featurize_smiles_routes_native():
    for bad in ("C1CC", "xyz", ""):
        with pytest.raises(ValueError):
            native.smiles_to_arrays_native(bad)
        with pytest.raises(ValueError):
            port_datasets.featurize_smiles(bad)
    got = port_datasets.featurize_smiles("CCO")
    want = native.smiles_to_arrays_native("CCO")
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


def test_past_capacity_takes_the_two_call_path(monkeypatch):
    """A molecule past the capacity buffers (``glam_featurize2``'s -2)
    is featurized by sizes first, then exact arrays: the same bytes."""
    smi = "CC(C)Cc1ccc(cc1)C(C)C(=O)O"
    want = native.smiles_to_arrays_native(smi)
    monkeypatch.setattr(native, "_CAP_ATOMS", 4)
    got = native.smiles_to_arrays_native(smi)
    assert all(g.tobytes() == w.tobytes() and g.shape == w.shape
               for g, w in zip(got, want))


def test_build_is_cached_and_hashed(tmp_path, monkeypatch):
    """The library is keyed by a hash of the source and the flags, built
    once (through a temporary name), and a compiler failure raises
    instead of falling back."""
    native.load_library()
    path = build.host_library_path("glam_native")
    assert path.is_file() and path.parent == build.BUILD_DIR
    assert build.host_source_hash("glam_native") in path.name
    assert build.build_host("glam_native") is False      # already built
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.build_host("glam_native")
    assert list(tmp_path.iterdir()) == []
