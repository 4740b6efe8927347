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

``load_jax_checkpoint(path)`` reads a checkpoint the JAX trainer wrote
(``best_save.ckpt``: flax msgpack, decoded by ``utils/msgpack.py``
without flax) and returns ``(args, state_dict)`` for a single-graph
model or a pair model; ``config_from_args(args)`` and
``pair_kind(args)`` (None, ``"homo"`` for the DDI tasks, ``"hetero"``
for the others) say which model the ``state_dict`` loads into.
"""
from __future__ import annotations

import json
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .nn.model import (Architecture, ModelConfig, PairArchitecture,
                       model_config_from_args)
from .utils import msgpack

# the DDI tasks, whose checkpoints hold the homo two-molecule model; the
# other pair tasks' hold the hetero (molecule, protein) model
HOMO_PAIR_TASKS = ("pair_binary_bce", "pair_multiclass")

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


def pair_kind(args: Mapping) -> Optional[str]:
    """None for a single-graph task, ``"homo"`` for a DDI pair task,
    ``"hetero"`` for the other pair tasks."""
    task = str(args.get("task", ""))
    if not task.startswith("pair_"):
        return None
    return "homo" if task in HOMO_PAIR_TASKS else "hetero"


def config_from_args(args: Mapping) -> ModelConfig:
    """The model config a checkpoint's ``args`` describe."""
    if "model_cfg" in args:
        return ModelConfig(**args["model_cfg"])
    return model_config_from_args(dict(args),
                                  out_dim=args.get("out_dim", 1))


def load_jax_checkpoint(path) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """(args, state_dict) of the JAX trainer's checkpoint at ``path``:
    its payload ``{args, records, params, batch_stats}``, the last two
    msgpack bytes themselves, converted by ``state_dict_from_jax``
    (BatchNorm running statistics included)."""
    payload = msgpack.unpackb(Path(path).read_bytes())
    args = json.loads(payload["args"])
    params = msgpack.unpackb(payload["params"])
    stats = msgpack.unpackb(payload["batch_stats"])
    return args, state_dict_from_jax(params, config_from_args(args),
                                     stats or None, pair_kind(args))
