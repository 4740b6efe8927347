"""Graph transforms, the port of the JAX package's ``data/transforms.py``.

``complete_graph`` replaces a graph's edge set with dense all-pairs
edges (no self loops), carrying the original edge attributes where an
edge existed and zeros elsewhere (the reference's ``Complete``
transform, which its main path does not use).
"""
from __future__ import annotations

import numpy as np

from .graph import GraphArrays


def complete_graph(g: GraphArrays) -> GraphArrays:
    n = g.nodes.shape[0]
    fe = g.edges.shape[1]
    src = np.repeat(np.arange(n), n)
    dst = np.tile(np.arange(n), n)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    attr = np.zeros((len(src), fe), np.float32)
    # index original attrs into the dense table (a repeated edge keeps
    # its last attributes)
    lookup = {(int(s), int(r)): i
              for i, (s, r) in enumerate(zip(g.senders, g.receivers))}
    for k, (s, r) in enumerate(zip(src, dst)):
        i = lookup.get((int(s), int(r)))
        if i is not None:
            attr[k] = g.edges[i]
    return g._replace(senders=src.astype(np.int32),
                      receivers=dst.astype(np.int32), edges=attr)
