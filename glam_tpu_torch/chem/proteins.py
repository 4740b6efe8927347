"""Protein featurization: sequence + contact map -> residue graph, a
verbatim copy of the JAX package's ``chem/proteins.py``.

Parity with the reference DTI tree:
  * 49-dim residue features (get_residue_features,
    src_2gi_dti_scr/utils.py:449-460): 20 one-hot residue type + 5 class
    flags (aliphatic/aromatic/polar-neutral/acidic/basic) + 7 physchem
    scalars (weight, pKa, pKb, pKx, pI, hydrophobicity at pH2/pH7) +
    7 Meiler + 10 Kidera descriptors.  The physchem/Meiler/Kidera tables
    are standard published constants.
  * graph edges (get_pro_nodes_edges, src_2gi_dti_scr/dataset.py:67-103):
    backbone chain i<->i+1 with attr [1,1,0,0,0,0,0,1] + one directed
    edge per nonzero contact-map entry with 8-dim attr
    [main_chain=0, p, 1-p, l1..l5 probability-bucket flags].  Note the
    reference's l4 bucket is [0.5, 0.9) — overlapping l3 — replicated
    verbatim since it defines the feature semantics trained models see.
  * RaptorX/CASP contact-map text parser (read_probs/load_contactmap,
    src_2gi_dti_scr/utils.py:235-293), threshold 0.1.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

NUM_PRO_NODE_FEATURES = 49
NUM_PRO_EDGE_FEATURES = 8

RES_TYPES = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M", "N",
             "P", "Q", "R", "S", "T", "V", "W", "Y"]
_ALIPHATIC = set("AILMV")
_AROMATIC = set("FWY")
_POLAR_NEUTRAL = set("CNQST")
_ACIDIC = set("DE")
_BASIC = set("HKR")

# standard residue physical-chemistry constants (monoisotopic-residue
# weight, pKa/pKb/pKx, isoelectric point, hydrophobicity at pH2/pH7)
RES_WEIGHT = {"A": 71.08, "C": 103.15, "D": 115.09, "E": 129.12,
              "F": 147.18, "G": 57.05, "H": 137.14, "I": 113.16,
              "K": 128.18, "L": 113.16, "M": 131.20, "N": 114.11,
              "P": 97.12, "Q": 128.13, "R": 156.19, "S": 87.08,
              "T": 101.11, "V": 99.13, "W": 186.22, "Y": 163.18}
RES_PKA = {"A": 2.34, "C": 1.96, "D": 1.88, "E": 2.19, "F": 1.83,
           "G": 2.34, "H": 1.82, "I": 2.36, "K": 2.18, "L": 2.36,
           "M": 2.28, "N": 2.02, "P": 1.99, "Q": 2.17, "R": 2.17,
           "S": 2.21, "T": 2.09, "V": 2.32, "W": 2.83, "Y": 2.32}
RES_PKB = {"A": 9.69, "C": 10.28, "D": 9.60, "E": 9.67, "F": 9.13,
           "G": 9.60, "H": 9.17, "I": 9.60, "K": 8.95, "L": 9.60,
           "M": 9.21, "N": 8.80, "P": 10.60, "Q": 9.13, "R": 9.04,
           "S": 9.15, "T": 9.10, "V": 9.62, "W": 9.39, "Y": 9.62}
RES_PKX = {"A": 0.0, "C": 8.18, "D": 3.65, "E": 4.25, "F": 0.0, "G": 0.0,
           "H": 6.0, "I": 0.0, "K": 10.53, "L": 0.0, "M": 0.0, "N": 0.0,
           "P": 0.0, "Q": 0.0, "R": 12.48, "S": 0.0, "T": 0.0, "V": 0.0,
           "W": 0.0, "Y": 0.0}
RES_PI = {"A": 6.00, "C": 5.07, "D": 2.77, "E": 3.22, "F": 5.48,
          "G": 5.97, "H": 7.59, "I": 6.02, "K": 9.74, "L": 5.98,
          "M": 5.74, "N": 5.41, "P": 6.30, "Q": 5.65, "R": 10.76,
          "S": 5.68, "T": 5.60, "V": 5.96, "W": 5.89, "Y": 5.96}
RES_HPHOB_PH2 = {"A": 47, "C": 52, "D": -18, "E": 8, "F": 92, "G": 0,
                 "H": -42, "I": 100, "K": -37, "L": 100, "M": 74,
                 "N": -41, "P": -46, "Q": -18, "R": -26, "S": -7, "T": 13,
                 "V": 79, "W": 84, "Y": 49}
RES_HPHOB_PH7 = {"A": 41, "C": 49, "D": -55, "E": -31, "F": 100, "G": 0,
                 "H": 8, "I": 99, "K": -23, "L": 97, "M": 74, "N": -28,
                 "P": -46, "Q": -10, "R": -14, "S": -5, "T": 13, "V": 76,
                 "W": 97, "Y": 63}
MEILER = {  # Meiler et al. 2001 reduced amino-acid parameter set
    "A": [1.28, 0.05, 1.00, 0.31, 6.11, 0.42, 0.23],
    "C": [1.77, 0.13, 2.43, 1.54, 6.35, 0.17, 0.41],
    "D": [1.60, 0.11, 2.78, -0.77, 2.95, 0.25, 0.20],
    "E": [1.56, 0.15, 3.78, -0.64, 3.09, 0.42, 0.21],
    "F": [2.94, 0.29, 5.89, 1.79, 5.67, 0.30, 0.38],
    "G": [0.00, 0.00, 0.00, 0.00, 6.07, 0.13, 0.15],
    "H": [2.99, 0.23, 4.66, 0.13, 7.69, 0.27, 0.30],
    "I": [4.19, 0.19, 4.00, 1.80, 6.04, 0.30, 0.45],
    "K": [1.89, 0.22, 4.77, -0.99, 9.99, 0.32, 0.27],
    "L": [2.59, 0.19, 4.00, 1.70, 6.04, 0.39, 0.31],
    "M": [2.35, 0.22, 4.43, 1.23, 5.71, 0.38, 0.32],
    "N": [1.60, 0.13, 2.95, -0.60, 6.52, 0.21, 0.22],
    "P": [2.67, 0.00, 2.72, 0.72, 6.80, 0.13, 0.34],
    "Q": [1.56, 0.18, 3.95, -0.22, 5.65, 0.36, 0.25],
    "R": [2.34, 0.29, 6.13, -1.01, 10.74, 0.36, 0.25],
    "S": [1.31, 0.06, 1.60, -0.04, 5.70, 0.20, 0.28],
    "T": [3.03, 0.11, 2.60, 0.26, 5.60, 0.21, 0.36],
    "V": [3.67, 0.14, 3.00, 1.22, 6.02, 0.27, 0.49],
    "W": [3.21, 0.41, 8.08, 2.25, 5.94, 0.32, 0.42],
    "Y": [2.94, 0.30, 6.47, 0.96, 5.66, 0.25, 0.41],
}
KIDERA = {  # Kidera et al. 1985 ten orthogonal factors
    "A": [-1.56, -1.67, -0.97, -0.27, -0.93, -0.78, -0.2, -0.08, 0.21,
          -0.48],
    "C": [0.12, -0.89, 0.45, -1.05, -0.71, 2.41, 1.52, -0.69, 1.13, 1.1],
    "D": [0.58, -0.22, -1.58, 0.81, -0.92, 0.15, -1.52, 0.47, 0.76, 0.7],
    "E": [-1.45, 0.19, -1.61, 1.17, -1.31, 0.4, 0.04, 0.38, -0.35, -0.12],
    "F": [-0.21, 0.98, -0.36, -1.43, 0.22, -0.81, 0.67, 1.1, 1.71, -0.44],
    "G": [1.46, -1.96, -0.23, -0.16, 0.1, -0.11, 1.32, 2.36, -1.66, 0.46],
    "H": [-0.41, 0.52, -0.28, 0.28, 1.61, 1.01, -1.85, 0.47, 1.13, 1.63],
    "I": [-0.73, -0.16, 1.79, -0.77, -0.54, 0.03, -0.83, 0.51, 0.66,
          -1.78],
    "K": [-0.34, 0.82, -0.23, 1.7, 1.54, -1.62, 1.15, -0.08, -0.48, 0.6],
    "L": [-1.04, 0.0, -0.24, -1.1, -0.55, -2.05, 0.96, -0.76, 0.45, 0.93],
    "M": [-1.4, 0.18, -0.42, -0.73, 2.0, 1.52, 0.26, 0.11, -1.27, 0.27],
    "N": [1.14, -0.07, -0.12, 0.81, 0.18, 0.37, -0.09, 1.23, 1.1, -1.73],
    "P": [2.06, -0.33, -1.15, -0.75, 0.88, -0.45, 0.3, -2.3, 0.74, -0.28],
    "Q": [-0.47, 0.24, 0.07, 1.1, 1.1, 0.59, 0.84, -0.71, -0.03, -2.33],
    "R": [0.22, 1.27, 1.37, 1.87, -1.7, 0.46, 0.92, -0.39, 0.23, 0.93],
    "S": [0.81, -1.08, 0.16, 0.42, -0.21, -0.43, -1.89, -1.15, -0.97,
          -0.23],
    "T": [0.26, -0.7, 1.21, 0.63, -0.1, 0.21, 0.24, -1.15, -0.56, 0.19],
    "V": [-0.74, -0.71, 2.04, -0.4, 0.5, -0.81, -1.07, 0.06, -0.46, 0.65],
    "W": [0.3, 2.1, -0.72, -1.57, -1.16, 0.57, -0.48, -0.4, -2.3, -0.6],
    "Y": [1.38, 1.48, 0.8, -0.56, -0.0, -0.68, -0.31, 1.03, -0.05, 0.53],
}


def residue_features(residue: str) -> List[float]:
    """49-dim residue feature vector; unknown residues get zero one-hot
    and raise on missing table entries (parity: the reference KeyErrors
    there too, and such proteins are skipped upstream)."""
    onehot = [1.0 if residue == r else 0.0 for r in RES_TYPES]
    flags = [1.0 if residue in _ALIPHATIC else 0.0,
             1.0 if residue in _AROMATIC else 0.0,
             1.0 if residue in _POLAR_NEUTRAL else 0.0,
             1.0 if residue in _ACIDIC else 0.0,
             1.0 if residue in _BASIC else 0.0]
    phys = [RES_WEIGHT[residue], RES_PKA[residue], RES_PKB[residue],
            RES_PKX[residue], RES_PI[residue],
            float(RES_HPHOB_PH2[residue]), float(RES_HPHOB_PH7[residue])]
    return onehot + flags + phys + MEILER[residue] + KIDERA[residue]


def protein_to_arrays(seq: str, contact_map: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """(nodes [L,49], senders [E], receivers [E], edge_attr [E,8])."""
    L = len(seq)
    nodes = np.asarray([residue_features(r) for r in seq], np.float32)
    # backbone chain, both directions, attr [1,1,0,0,0,0,0,1]
    src = []
    dst = []
    attrs = []
    for i in range(L - 1):
        src += [i, i + 1]
        dst += [i + 1, i]
        attrs.append([1, 1, 0, 0, 0, 0, 0, 1])
        attrs.append([1, 1, 0, 0, 0, 0, 0, 1])
    # contact edges (every nonzero entry; the symmetric matrix already
    # contains both directions)
    rows, cols = np.where(contact_map > 0)
    for i, j in zip(rows.tolist(), cols.tolist()):
        p = float(contact_map[i, j])
        attrs.append([0, p, 1.0 - p,
                      float(0.0 <= p < 0.3), float(0.3 <= p < 0.5),
                      float(0.5 <= p < 0.7),
                      float(0.5 <= p < 0.9),   # reference's overlapping l4
                      float(0.9 <= p <= 1.0)])
        src.append(i)
        dst.append(j)
    return (nodes, np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(attrs, np.float32).reshape(-1, NUM_PRO_EDGE_FEATURES))


# ----------------------- contact map parsing ----------------------------

_HEADER_PREFIXES = ("PFRMAT", "TARGET", "AUTHOR", "METHOD", "RMODE",
                    "MODEL", "REMARK", "END")


def read_probs(path) -> Optional[Tuple[List[List[float]], str, Dict]]:
    """Parse RaptorX/CASP contact text: SEQ lines + 'i j prob' rows."""
    content = Path(path).read_text().splitlines()
    if len(content) < 5:
        raise ValueError("the input file contains fewer than 5 lines")
    seq = ""
    infos: Dict[str, List[str]] = {}
    probs: List[List[float]] = []
    for line in content:
        if "SEQ" in line:
            seq += line.split()[-1]
            continue
        if line.startswith(_HEADER_PREFIXES):
            parts = line.split()
            infos[parts[0]] = parts[1:]
            continue
        cols = line.split()
        if len(cols) >= 3:
            i, j = int(cols[0]), int(cols[1])
            p = float(cols[2])
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"contact prob out of range: {line!r}")
            if i >= j:
                raise ValueError(f"first index must be smaller: {line!r}")
            if i < 1 or j > len(seq):
                return None  # out-of-range row: reject file (reference)
            probs.append([i, j, p])
        elif line.strip():
            return None  # malformed row: reject file (reference)
    return probs, seq, infos


def load_contactmap(path, thre: float = 0.1
                    ) -> Tuple[np.ndarray, str, Dict]:
    """Dense symmetric LxL prob matrix thresholded at ``thre``."""
    parsed = read_probs(path)
    if parsed is None:
        raise ValueError(f"malformed contact map: {path}")
    probs, seq, infos = parsed
    cm = np.zeros((len(seq), len(seq)), np.float32)
    for i, j, p in probs:
        if p >= thre:
            cm[i - 1, j - 1] = p
            cm[j - 1, i - 1] = p
    return cm, seq, infos
