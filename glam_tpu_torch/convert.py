"""Carry weights from the JAX package's ``Architecture`` to the port's.

``state_dict_from_jax(params, cfg)`` takes the JAX parameter tree as
nested mappings of numpy arrays (``jax.tree_util.tree_map(np.asarray,
variables["params"])``, or a decoded checkpoint) and returns the port's
``state_dict``.  Dense and GRU kernels are stored [in, out] on the JAX
side and are transposed to torch's [out, in]; the TripletMessage weights
keep their [in, out] layout.  A missing, extra or misshapen entry raises.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .nn.model import Architecture, ModelConfig

# JAX leaf name -> (port name, transpose)
_LEAVES = {"kernel": ("weight", True),
           "w_ih": ("weight_ih", True), "w_hh": ("weight_hh", True),
           "b_ih": ("bias_ih", False), "b_hh": ("bias_hh", False)}
# JAX auto-named submodules -> port attribute names
_MODULES = {"TripletMessage_0": "conv"}


def transposed_from_jax(name: str) -> bool:
    """Whether the port stores the ``state_dict`` entry ``name``
    transposed from the JAX layout (torch's [out, in] for JAX's
    [in, out]), as ``state_dict_from_jax`` converts it."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in {port for port, transpose in _LEAVES.values()
                    if transpose}


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_jax(params: Mapping,
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    expected = Architecture(cfg).state_dict()
    out = {}
    for path, leaf in _leaves(params):
        name, transpose = _LEAVES.get(path[-1], (path[-1], False))
        key = ".".join([_MODULES.get(m, m) for m in path[:-1]] + [name])
        if key not in expected:
            raise KeyError(f"JAX parameter {'/'.join(path)} has no "
                           f"counterpart in the port (as {key!r})")
        arr = np.asarray(leaf, np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"JAX parameter {'/'.join(path)} has shape "
                             f"{arr.shape}; {key} needs "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX parameter tree lacks {missing}")
    return out
