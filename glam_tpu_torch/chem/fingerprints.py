"""Morgan-style circular fingerprints + vectorized Tanimoto similarity,
a copy of the JAX package's ``chem/fingerprints.py`` (which imports no
JAX; the port imports nothing of that package).

RDKit-free replacement for the fingerprint step of the reference's
perturbation-benchmark builder
(reference src_perturbed_dataset/perturb-real_point.ipynb cells
9-12: ``RDKFingerprint`` + ``FingerprintSimilarity`` over all molecule
pairs).  The reference uses Daylight-style path fingerprints; we use
ECFP-style circular (Morgan) fingerprints built on the same WL-label
machinery as chem/scaffold.py — both are standard structural
fingerprints whose Tanimoto similarity ranks molecular neighborhoods;
the builder's bucket thresholds apply to OUR fingerprint (documented in
data/perturb_builder.py, not claimed bit-identical to RDKit).

Fingerprints are bit-packed into uint64 rows so all-pairs Tanimoto runs
as blocked numpy popcounts (np.bitwise_count) — the reference's
pure-Python double loop took 4 hours on 12.6k molecules (notebook cell
12); this computes the same 160M pairs in seconds.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from .smiles import Mol, SmilesError, parse_smiles

_BOND_ORDER_LABEL = {1: "1", 2: "2", 3: "3", 4: "a"}


def _hash32(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:4], "little")


def morgan_bits(mol: Mol, radius: int = 2, n_bits: int = 2048) -> set:
    """Set of folded bit positions of the ECFP-style fingerprint."""
    n = mol.num_atoms()
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for b in mol.bonds:
        o = _BOND_ORDER_LABEL.get(b.order, "?")
        adj[b.a].append((b.b, o))
        adj[b.b].append((b.a, o))
    # initial atom invariants (ECFP: element, charge, H, degree,
    # aromaticity, ring membership)
    ids = [
        _hash32(f"{a.symbol}|{a.charge}|{a.num_h}|{len(adj[i])}"
                f"|{int(a.aromatic)}|{int(a.in_ring)}")
        for i, a in enumerate(mol.atoms)]
    bits = set(ids)
    for _ in range(radius):
        nxt = []
        for i in range(n):
            neigh = sorted(f"{o}:{ids[j]}" for (j, o) in adj[i])
            nxt.append(_hash32(f"{ids[i]}|" + ";".join(neigh)))
        ids = nxt
        bits.update(ids)
    return {b % n_bits for b in bits}


def fingerprint(smiles: str, radius: int = 2,
                n_bits: int = 2048) -> Optional[np.ndarray]:
    """Packed uint64 fingerprint row (None if unparseable)."""
    try:
        mol = parse_smiles(smiles)
    except SmilesError:
        return None
    packed = np.zeros(n_bits // 64, np.uint64)
    for b in morgan_bits(mol, radius, n_bits):
        packed[b // 64] |= np.uint64(1) << np.uint64(b % 64)
    return packed


def fingerprint_matrix(smiles: List[str], radius: int = 2,
                       n_bits: int = 2048) -> np.ndarray:
    """[N, n_bits/64] packed fingerprints (unparseable rows all-zero)."""
    out = np.zeros((len(smiles), n_bits // 64), np.uint64)
    for i, s in enumerate(smiles):
        fp = fingerprint(s, radius, n_bits)
        if fp is not None:
            out[i] = fp
    return out


def tanimoto(a: np.ndarray, b: np.ndarray) -> float:
    inter = int(np.bitwise_count(a & b).sum())
    union = int(np.bitwise_count(a | b).sum())
    return inter / union if union else 0.0


def tanimoto_row(fps: np.ndarray, i: int,
                 popcounts: Optional[np.ndarray] = None) -> np.ndarray:
    """Tanimoto of row i against ALL rows (vectorized popcounts)."""
    if popcounts is None:
        popcounts = np.bitwise_count(fps).sum(axis=1)
    inter = np.bitwise_count(fps & fps[i]).sum(axis=1).astype(np.float64)
    union = popcounts + popcounts[i] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.where(union > 0, inter / union, 0.0)
    return sim
