"""Graph readouts.  Only ``GlobalPool5`` is ported so far; the other
names of the JAX package's ``nn/readouts.py`` raise and name their
ROADMAP item."""
from __future__ import annotations

import torch

from ..ops.segment import segment_sum, segment_topk_by_channel

_NOT_PORTED = ("GlobalLAPool", "Set2Set")


class GlobalPool5(torch.nn.Module):
    """[mean, sum, top-3-by-last-channel] concat readout -> 5C."""

    def __init__(self, channels: int, max_nodes: int = 128, k: int = 3):
        super().__init__()
        self.channels, self.max_nodes, self.k = channels, max_nodes, k

    def forward(self, x, node_graph, node_pos, n_node):
        G = n_node.shape[0]
        total = segment_sum(x, node_graph, G)
        mean = total / n_node.clamp(min=1).to(x.dtype)[:, None]
        topk = segment_topk_by_channel(x, node_graph, node_pos, G,
                                       self.max_nodes, self.k)
        return torch.cat([mean, total, topk], dim=-1)


def get_readout(name: str, channels: int, max_nodes: int):
    """-> (module, width multiplier)."""
    key = name.strip()
    if key == "GlobalPool5":
        return GlobalPool5(channels, max_nodes), 5
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"readout {key!r} is not ported yet (ROADMAP queue A, 'Rest "
            "of the layer library')")
    raise KeyError(f"unknown readout {name!r}")
