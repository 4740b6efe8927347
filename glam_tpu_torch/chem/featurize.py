"""Molecule featurization: SMILES -> node/edge feature arrays.

A copy of the JAX package's ``chem/featurize.py`` (the port imports
nothing of that package).  Output is byte-identical to it, which
``tests/test_torch_port_data.py`` checks.

Node features (15 dims):
  [0:9]   one-hot atom symbol over [H, C, N, O, F, S, Cl, Br, I]
  [9:12]  one-hot hybridization over [SP, SP2, SP3] (all-zero for others)
  [12]    atomic number
  [13]    aromatic flag (0/1)
  [14]    num explicit-H neighbors (implicit Hs do not count)

Edge features (4 dims): one-hot bond type [SINGLE, DOUBLE, TRIPLE,
AROMATIC].  Every bond is inserted in both directions, then edges are
sorted by ``src * N + dst``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .smiles import (AROMATIC, DOUBLE, SINGLE, SP, SP2, SP3, TRIPLE, Mol,
                     SmilesError, parse_smiles)

ATOM_SYMBOLS = ["H", "C", "N", "O", "F", "S", "Cl", "Br", "I"]
NUM_NODE_FEATURES = 15
NUM_EDGE_FEATURES = 4


class FeaturizeError(ValueError):
    pass


def one_of_k(value, allowed) -> np.ndarray:
    """One-hot; unknown values yield all-zeros."""
    return np.asarray([value == a for a in allowed], np.float32)


def mol_to_arrays(mol: Mol) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Featurize a parsed molecule.

    Returns (x [N,15], senders [E], receivers [E], edge_attr [E,4]),
    with E = 2 * num_bonds and edges sorted by ``src * N + dst``.
    """
    n = mol.num_atoms()
    if n == 0:
        raise FeaturizeError("empty molecule")
    hyb_map = {SP: 0, SP2: 1, SP3: 2}
    x = np.zeros((n, NUM_NODE_FEATURES), np.float32)
    for i, atom in enumerate(mol.atoms):
        x[i, :9] = one_of_k(atom.symbol, ATOM_SYMBOLS)
        h = hyb_map.get(atom.hybridization)
        if h is not None:
            x[i, 9 + h] = 1.0
        x[i, 12] = atom.atomic_num
        x[i, 13] = 1.0 if atom.aromatic else 0.0
    # explicit-H neighbor count (scatter of H indicators over bonds)
    for b in mol.bonds:
        if mol.atoms[b.a].symbol == "H":
            x[b.b, 14] += 1.0
        if mol.atoms[b.b].symbol == "H":
            x[b.a, 14] += 1.0

    e = len(mol.bonds)
    src = np.empty((2 * e,), np.int64)
    dst = np.empty((2 * e,), np.int64)
    bond_onehot = {SINGLE: 0, DOUBLE: 1, TRIPLE: 2, AROMATIC: 3}
    attr = np.zeros((2 * e, NUM_EDGE_FEATURES), np.float32)
    for k, b in enumerate(mol.bonds):
        src[2 * k], dst[2 * k] = b.a, b.b
        src[2 * k + 1], dst[2 * k + 1] = b.b, b.a
        if b.order not in bond_onehot:
            raise FeaturizeError(f"unsupported bond order {b.order}")
        attr[2 * k, bond_onehot[b.order]] = 1.0
        attr[2 * k + 1, bond_onehot[b.order]] = 1.0
    perm = np.argsort(src * n + dst, kind="stable")
    return (x, src[perm].astype(np.int32), dst[perm].astype(np.int32),
            attr[perm])


def smiles_to_arrays(smiles: str):
    """SMILES -> feature arrays; raises on unparseable/unfeaturizable input."""
    try:
        mol = parse_smiles(smiles)
    except SmilesError as exc:
        raise FeaturizeError(str(exc)) from exc
    return mol_to_arrays(mol)


def is_valid_smiles(smiles: str) -> bool:
    if not isinstance(smiles, str) or not smiles:
        return False
    try:
        smiles_to_arrays(smiles)
    except ValueError:
        return False
    return True
