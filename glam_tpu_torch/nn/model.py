"""The models, with the JAX package's config strings and semantics
(``nn/model.py``):

  Architecture      single graph: pre-linear -> message_steps x
                    weight-tied MessageBlock -> readout -> flat
                    LinearBlock -> lin_out1
  PairArchitecture  two towers with separate weights and a cross-graph
                    fusion per message step -> lin_out0 -> lin_out1; the
                    homo DDI model (two molecules) and, with ``hetero``,
                    the DTI model (molecule and protein contact map)

Module names follow the JAX parameter tree (``mol.lin0``, ``mol.conv``,
``mol.flat``, ``lin_out1``; ``mol1``, ``mol2``, ``lin_out0``), so
``convert.state_dict_from_jax`` maps one onto the other name for name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..data.graph import GraphBatch
from .blocks import LinearBlock, MessageBlock
from .fusion import dot_and_global_pool
from .init import reset_parameters
from .readouts import get_readout


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (a copy of the JAX package's)."""
    mol_in_dim: int = 15
    mol_edge_in_dim: int = 4
    pro_in_dim: int = 49
    pro_edge_in_dim: int = 8
    hid_dim_alpha: int = 4
    e_dim: int = 1024
    out_dim: int = 1
    mol_block: str = "_NNConv"
    pro_block: str = "_GCNConv"
    message_steps: int = 3
    mol_readout: str = "GlobalPool5"
    pro_readout: str = "GlobalPool5"
    pre_norm: str = "_None"
    graph_norm: str = "_None"
    flat_norm: str = "_None"
    end_norm: str = "_None"
    pre_do: str = "_None()"
    graph_do: str = "Dropout(0.2)"
    flat_do: str = "_None()"
    end_do: str = "Dropout(0.2)"
    pre_act: str = "RReLU"
    graph_act: str = "RReLU"
    flat_act: str = "RReLU"
    end_act: str = "RReLU"
    graph_res: bool = True
    # static per-graph node cap for dense ops (sort-pool)
    max_nodes: int = 132
    pro_max_nodes: int = 1024

    @property
    def hid_dim(self) -> int:
        return self.mol_in_dim * self.hid_dim_alpha


class _Tower(torch.nn.Module):
    """pre-linear -> message_steps x weight-tied MessageBlock (GRU state
    threaded) -> readout -> flat LinearBlock."""

    def __init__(self, in_dim: int, edge_dim: int, hid_dim: int,
                 flat_out: int, block: str, readout: str,
                 message_steps: int, cfg: ModelConfig, max_nodes: int):
        super().__init__()
        c = cfg
        self.message_steps = message_steps
        self.lin0 = LinearBlock(in_dim, hid_dim, norm=c.pre_norm,
                                dropout=c.pre_do, act=c.pre_act)
        self.conv = MessageBlock(hid_dim, hid_dim, edge_dim,
                                 norm=c.graph_norm, dropout=c.graph_do,
                                 conv=block, act=c.graph_act,
                                 res=c.graph_res)
        self.readout, mult = get_readout(readout, hid_dim, max_nodes)
        self.flat = LinearBlock(mult * hid_dim, flat_out, norm=c.flat_norm,
                                dropout=c.flat_do, act=c.flat_act)

    def forward(self, g: GraphBatch, return_nodes: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.lin0(g.nodes, generator, node_graph=g.node_graph,
                      n_node=g.n_node, node_mask=g.node_mask,
                      graph_rowptr=g.graph_rowptr)
        h = None
        xs = []
        for _ in range(self.message_steps):
            x, h = self.conv(x, g, h, generator)
            xs.append(x)
        out = self.flat(self.readout(x, g.node_graph, g.node_pos, g.n_node,
                                     g.graph_rowptr), generator)
        return (out, xs) if return_nodes else out


class Architecture(torch.nn.Module):
    """Single-graph model.  Parameters are drawn from ``generator``
    (a fresh one seeded with 0 when None), on the CPU.

    ``forward(g, return_nodes=False, generator=None)``: in ``train()``
    mode the dropout masks and RReLU slopes are drawn from ``generator``
    (on the model's device), which is then required if the config has
    noise; in ``eval()`` mode the forward is deterministic."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        self.mol = _Tower(c.mol_in_dim, c.mol_edge_in_dim, c.hid_dim,
                          c.e_dim, c.mol_block, c.mol_readout,
                          c.message_steps, c, c.max_nodes)
        self.lin_out1 = LinearBlock(c.e_dim, c.out_dim, norm=c.end_norm,
                                    dropout=c.end_do, act="_None")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, g: GraphBatch, return_nodes: bool = False,
                generator: Optional[torch.Generator] = None):
        res = self.mol(g, return_nodes=return_nodes, generator=generator)
        out = self.lin_out1(res[0] if return_nodes else res, generator)
        return (out, res[1]) if return_nodes else out


class PairArchitecture(torch.nn.Module):
    """Two-tower pair model with a cross-graph fusion per message step.

    ``hetero`` takes the ``pro_*`` dims and config for the second tower
    (DTI); without it both towers are molecule towers with separate
    weights (DDI).  Parameters and noise as in :class:`Architecture`;
    ``forward(g1, g2, generator=None)``, labels on ``g1``."""

    def __init__(self, cfg: ModelConfig, hetero: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.cfg = cfg
        self.hetero = hetero
        hid = c.hid_dim
        self.mol1 = _Tower(c.mol_in_dim, c.mol_edge_in_dim, hid, hid,
                           c.mol_block, c.mol_readout, c.message_steps, c,
                           c.max_nodes)
        self.max_nodes2 = c.pro_max_nodes if hetero else c.max_nodes
        self.mol2 = _Tower(
            c.pro_in_dim if hetero else c.mol_in_dim,
            c.pro_edge_in_dim if hetero else c.mol_edge_in_dim, hid, hid,
            c.pro_block if hetero else c.mol_block,
            c.pro_readout if hetero else c.mol_readout, c.message_steps, c,
            self.max_nodes2)
        self.lin_out0 = LinearBlock(hid * 2 + 2 * c.message_steps, c.e_dim,
                                    norm=c.end_norm, dropout=c.end_do,
                                    act=c.end_act)
        self.lin_out1 = LinearBlock(c.e_dim, c.out_dim, norm=c.end_norm,
                                    dropout=c.end_do, act="_None")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_parameters(self, generator)

    def forward(self, g1: GraphBatch, g2: GraphBatch,
                generator: Optional[torch.Generator] = None):
        out1, xs1 = self.mol1(g1, return_nodes=True, generator=generator)
        out2, xs2 = self.mol2(g2, return_nodes=True, generator=generator)
        fusion = [dot_and_global_pool(
            x1, x2, g1.node_graph, g1.node_pos, g1.n_node, g2.node_graph,
            g2.node_pos, g2.n_node, g1.num_graphs, self.cfg.max_nodes,
            self.max_nodes2, stats5=False) for x1, x2 in zip(xs1, xs2)]
        out = self.lin_out0(torch.cat([out1, out2] + fusion, dim=-1),
                            generator)
        return self.lin_out1(out, generator)


_NON_MODEL_ARGS = frozenset([
    "dataset_root", "dataset", "split", "seed", "gpu", "note", "batch_size",
    "epochs", "loss", "optim", "k", "lr", "lr_reduce_rate",
    "lr_reduce_patience", "early_stop_patience", "verbose_patience",
    "split_seed", "test", "n_init_configs", "n_low_fidelity_seed",
    "n_top_blend", "n_high_fidelity_seed",
])


def model_config_from_args(args: dict, **overrides) -> ModelConfig:
    """A ModelConfig from a flat config dict, ignoring trainer-level
    keys."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kwargs = {}
    for k, v in args.items():
        if k in _NON_MODEL_ARGS or k not in fields:
            continue
        if k == "graph_res":
            v = bool(v)
        kwargs[k] = v
    kwargs.update(overrides)
    return ModelConfig(**kwargs)
