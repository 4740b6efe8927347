"""ctypes bindings of the C++ SMILES featurizer (``csrc/glam_native.cpp``,
a copy of the JAX package's ``native/csrc/glam_native.cpp``).

``smiles_to_arrays_native(smiles)`` returns what
:func:`glam_tpu_torch.chem.featurize.smiles_to_arrays` returns, byte for
byte, and raises ``ValueError`` where it raises.  The library is built by
``ops/kernels/build.py`` (``build_host``, ``g++``) at first use; a build
that fails raises, and nothing falls back to the Python featurizer, which
stays the oracle the tests hold this one against.

Of the library's five functions three are bound: ``glam_smiles_sizes``,
``glam_featurize`` and ``glam_featurize2``.  ``glam_build_ell`` builds the
JAX package's ELL layout, which the port does not have (its receiver CSR,
``data/graph.py``, replaced it); ``glam_pack_batch`` is the JAX package's
opt-in batch packer, measured slower there than its numpy loop.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..ops.kernels import build

_lib = None


def load_library() -> ctypes.CDLL:
    """The featurizer library, built first if needed; raises if it cannot
    be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load_host("glam_native")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.glam_smiles_sizes.restype = ctypes.c_int
    lib.glam_smiles_sizes.argtypes = [ctypes.c_char_p, int_p, int_p]
    lib.glam_featurize.restype = ctypes.c_int
    lib.glam_featurize.argtypes = [ctypes.c_char_p, f32, i32, i32, f32]
    lib.glam_featurize2.restype = ctypes.c_int
    lib.glam_featurize2.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, f32, i32, i32, f32,
                                    int_p, int_p]
    _lib = lib
    return lib


_CAP_ATOMS = 1024
_CAP_EDGES = 4096


def smiles_to_arrays_native(smiles: str
                            ) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray]:
    """(x [N, 15] float32, senders, receivers [E] int32, edge_attr [E, 4]
    float32); raises ``ValueError`` where the Python featurizer does.
    One parse into capacity buffers (``glam_featurize2``); a molecule
    past their capacity takes the exact-size two-call path."""
    lib = load_library()
    x = np.empty((_CAP_ATOMS, 15), np.float32)
    snd = np.empty((_CAP_EDGES,), np.int32)
    rcv = np.empty((_CAP_EDGES,), np.int32)
    attr = np.empty((_CAP_EDGES, 4), np.float32)
    n, e = ctypes.c_int(), ctypes.c_int()
    rc = lib.glam_featurize2(smiles.encode(), _CAP_ATOMS, _CAP_EDGES,
                             x, snd, rcv, attr, ctypes.byref(n),
                             ctypes.byref(e))
    if rc == 0:
        return (x[:n.value].copy(), snd[:e.value].copy(),
                rcv[:e.value].copy(), attr[:e.value].copy())
    if rc == -1:
        raise ValueError(f"native parse failed: {smiles!r}")
    # rc == -2: past the capacity buffers; sizes first, then exact arrays
    na, ne = ctypes.c_int(), ctypes.c_int()
    if lib.glam_smiles_sizes(smiles.encode(), ctypes.byref(na),
                             ctypes.byref(ne)) != 0:
        raise ValueError(f"native parse failed: {smiles!r}")
    n, e = na.value, ne.value
    x = np.zeros((n, 15), np.float32)
    snd = np.zeros((e,), np.int32)
    rcv = np.zeros((e,), np.int32)
    attr = np.zeros((e, 4), np.float32)
    if lib.glam_featurize(smiles.encode(), x, snd, rcv, attr) != 0:
        raise ValueError(f"native featurize failed: {smiles!r}")
    return x, snd, rcv, attr
