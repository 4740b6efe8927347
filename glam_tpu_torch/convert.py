"""Carry weights from the JAX package's ``Architecture`` or
``PairArchitecture`` to the port's.

``state_dict_from_jax(params, cfg, batch_stats=None, pair=None)`` takes
the JAX
parameter tree as nested mappings of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables["params"])``, or a
decoded checkpoint) and, for a model with ``_BatchNorm``, its
``batch_stats`` collection (``mean``, ``var``), and returns the port's
``state_dict``: the parameters, and the BatchNorm running statistics when
``batch_stats`` is given (without it only the parameters, as for a tree
of gradients).  ``pair`` builds the pair model: ``"homo"`` (DDI, two
molecule towers) or ``"hetero"`` (DTI, the second tower the protein's);
its ``mol1``, ``mol2``, ``lin_out0`` and ``lin_out1`` names are the JAX
tree's.  Dense, GRU and GCN/GAT kernels are stored [in, out] on
the JAX side and are transposed to torch's [out, in]; the other weights
(TripletMessage's, NNConv's root, Set2Set's LSTM) keep their layout.  A
missing, extra or misshapen entry raises.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .nn.model import Architecture, ModelConfig, PairArchitecture

# JAX leaf name -> (port name, transpose)
_LEAVES = {"kernel": ("weight", True), "weight": ("weight", True),
           "w_ih": ("weight_ih", True), "w_hh": ("weight_hh", True),
           "b_ih": ("bias_ih", False), "b_hh": ("bias_hh", False)}
# JAX auto-named submodules (flax names an unnamed child by its class)
# -> port attribute names
_MODULES = {"TripletMessage_0": "conv", "TripletMessageLight_0": "conv",
            "NNConv_0": "conv", "GCNConv_0": "conv", "GATConv_0": "conv",
            "BatchNorm_0": "norm", "GraphLayerNorm_0": "norm"}


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


def convert_tree(tree: Mapping, expected: Dict[str, torch.Tensor],
                 what: str = "parameter") -> Dict[str, torch.Tensor]:
    """The JAX ``tree`` as tensors under the names of ``expected`` (the
    port's tensors, e.g. a module's ``named_parameters()``), each checked
    against its shape; every name of ``expected`` must be filled."""
    out = {}
    for path, leaf in _leaves(tree):
        name, transpose = _LEAVES.get(path[-1], (path[-1], False))
        key = ".".join([_MODULES.get(m, m) for m in path[:-1]] + [name])
        if key not in expected:
            raise KeyError(f"JAX {what} {'/'.join(path)} has no "
                           f"counterpart in the port (as {key!r})")
        arr = np.asarray(leaf, np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"JAX {what} {'/'.join(path)} has shape "
                             f"{arr.shape}; {key} needs "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.tensor(arr)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX {what} tree lacks {missing}")
    return out


def state_dict_from_jax(params: Mapping, cfg: ModelConfig,
                        batch_stats: Optional[Mapping] = None,
                        pair: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    if pair is None:
        model = Architecture(cfg)
    elif pair in ("homo", "hetero"):
        model = PairArchitecture(cfg, hetero=pair == "hetero")
    else:
        raise ValueError(f"pair must be None, 'homo' or 'hetero', not "
                         f"{pair!r}")
    weights = dict(model.named_parameters())
    out = convert_tree(params, weights)
    if batch_stats is not None:
        stats = {k: v for k, v in model.state_dict().items()
                 if k not in weights}
        out.update(convert_tree(batch_stats, stats, "batch statistic"))
    return out
