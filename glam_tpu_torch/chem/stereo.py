"""Weisfeiler-Lehman label refinement, a verbatim copy of ``wl_refine``
from the JAX package's ``chem/stereo.py``.

The scaffold split (``chem/scaffold.py``) is its only user so far; the
canonical stereo descriptors of that module serve the DDI molecule store
and come with the pair slice (ROADMAP A4).
"""
from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, List, Tuple


def wl_refine(labels: Dict[int, str],
              edges: List[Tuple[int, int, object]],
              rounds: int = 4) -> Dict[int, str]:
    """Weisfeiler-Lehman label refinement (the loop _wl_hash runs, made
    reusable so stereo ranking and hashing share one definition)."""
    adj = defaultdict(list)
    for (a, b, o) in edges:
        adj[a].append((b, o))
        adj[b].append((a, o))
    cur = dict(labels)
    for _ in range(rounds):
        nxt = {}
        for v, lab in cur.items():
            neigh = sorted(f"{o}:{cur[w]}" for (w, o) in adj[v])
            nxt[v] = hashlib.md5(
                (lab + "|" + ";".join(neigh)).encode()).hexdigest()[:16]
        cur = nxt
    return cur
