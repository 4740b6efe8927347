"""Chemistry-standard 2D structure-diagram coordinates (no RDKit).

The reference renders attention onto RDKit 2D depictions via
SimilarityMaps (reference src_1gp/visualize_gp.py:61-131).  The
round-3 renderer used a generic Fruchterman-Reingold spring layout,
which distorts fused-ring systems and macrocycles into shapes chemists
do not recognize.  This module generates coordinates the way chemical
structure-diagram generators do:

  * every ring is drawn as a REGULAR polygon with unit bond length;
  * fused rings are reflected across their shared edge (naphthalene's
    two hexagons, azulene's 5-7 pair, caffeine's 6-5 pair all come out
    as chemists draw them); spiro rings attach at the shared atom;
  * acyclic atoms extend at the standard 120-degree zigzag, with
    substituents placed into the largest free angular gap around their
    parent; sp-centers (triple bonds, allene middles) are collinear;
  * a placement-time collision check nudges atoms that would land on
    top of existing ones into the next-best free direction;
  * disconnected components (salts) are laid out independently and
    arranged side by side.

Bridged polycyclics (norbornane-class) fall back to approximate
placement for the bridge atoms — the documented limitation vs a full
SDG implementation.  Output is normalized to [-1, 1] like the previous
spring layout, so every renderer consumes it unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..chem.smiles import TRIPLE, Mol
from ..chem.smiles import _ring_bonds as _cycles

BOND = 1.0


def _edge_set(cycle: List[int]) -> frozenset:
    m = len(cycle)
    return frozenset(frozenset((cycle[k], cycle[(k + 1) % m]))
                     for k in range(m))


def _edges_to_cycle(edges: frozenset) -> Optional[List[int]]:
    """Walk an edge set back into one simple atom cycle (None if the
    set is not a single cycle)."""
    adj: Dict[int, List[int]] = {}
    for e in edges:
        a, b = tuple(e)
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    if any(len(v) != 2 for v in adj.values()):
        return None
    start = next(iter(adj))
    cycle = [start]
    prev, cur = None, start
    while True:
        nxt = [w for w in adj[cur] if w != prev]
        if not nxt:
            return None
        prev, cur = cur, nxt[0]
        if cur == start:
            break
        cycle.append(cur)
        if len(cycle) > len(edges):
            return None
    return cycle if len(cycle) == len(edges) else None


def _small_rings(mol: Mol) -> List[List[int]]:
    """SSSR-style small rings: reduce the BFS fundamental cycles by
    XOR-ing pairs until no combination yields a smaller single cycle
    (naphthalene's 6+10 fundamental basis becomes 6+6, azulene's
    5+10 becomes 5+7, anthracene's chain reduces fully)."""
    cycles = [_edge_set(c) for c in _cycles(mol, max_size=14)]
    changed = True
    guard = 0
    while changed and guard < 20:
        changed = False
        guard += 1
        for i in range(len(cycles)):
            for j in range(len(cycles)):
                if i == j:
                    continue
                big, small = ((i, j) if len(cycles[i]) >= len(cycles[j])
                              else (j, i))
                d = cycles[big] ^ cycles[small]
                if not d or len(d) >= len(cycles[big]):
                    continue
                if _edges_to_cycle(d) is not None:
                    cycles[big] = d
                    changed = True
    out = []
    seen = set()
    small_edges: set = set()
    for es in sorted(cycles, key=len):
        if es in seen:
            continue
        seen.add(es)
        c = _edges_to_cycle(es)
        if c is None:
            continue
        if len(c) <= 8:
            out.append(c)
            small_edges |= set(es)
        elif len(c) <= 12 and not (set(es) <= small_edges):
            # macrocycle (crown-ether class): draw as a polygon too,
            # unless it is just a spurious union of smaller rings
            out.append(c)
    return out


def _ring_systems(rings: List[List[int]]) -> List[List[int]]:
    """Group ring indices into fused systems (sharing >= 1 atom)."""
    n = len(rings)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    sets = [set(r) for r in rings]
    for i in range(n):
        for j in range(i + 1, n):
            if sets[i] & sets[j]:
                parent[find(i)] = find(j)
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _polygon_positions(cycle: List[int], fixed: Dict[int, np.ndarray],
                       away_from: Optional[np.ndarray]) -> Dict[int, np.ndarray]:
    """Place ``cycle`` as a regular polygon with unit sides.

    ``fixed`` pins already-placed member atoms (0, 1 shared atom, or a
    shared edge); ``away_from`` is a point (e.g. the neighboring ring's
    center) the new polygon's center must avoid."""
    m = len(cycle)
    r = BOND / (2.0 * math.sin(math.pi / m))  # circumradius
    pinned = [a for a in cycle if a in fixed]
    if len(pinned) >= 2:
        # find a pinned ADJACENT pair in the cycle = the shared edge
        v = None
        for k in range(m):
            u, v2 = cycle[k], cycle[(k + 1) % m]
            if u in fixed and v2 in fixed:
                v = v2
                break
        if v is None:
            # pinned atoms not adjacent (bridged): anchor the polygon
            # on ONE pinned atom instead of discarding the anchors —
            # drop to the single-pin branch below
            pinned = [pinned[0]]
        if v is not None:
            # orient the cycle so walking from v proceeds AWAY from u
            idx = cycle.index(v)
            if cycle[(idx + 1) % m] == u:
                cycle = cycle[::-1]
                idx = cycle.index(v)
            pu, pv = fixed[u], fixed[v]
            mid = (pu + pv) / 2.0
            edge = pv - pu
            elen = np.linalg.norm(edge) + 1e-12
            normal = np.array([-edge[1], edge[0]]) / elen
            h = math.sqrt(max(r * r - (elen / 2.0) ** 2, 0.0))
            c1, c2 = mid + normal * h, mid - normal * h
            if len(pinned) > 2:
                # peri-fused: pick the center that best fits ALL pinned
                # atoms at the circumradius
                def fit(c):
                    return sum(abs(np.linalg.norm(fixed[p] - c) - r)
                               for p in pinned)
                center = c1 if fit(c1) <= fit(c2) else c2
            elif away_from is None:
                center = c1
            else:
                center = (c1 if np.linalg.norm(c1 - away_from)
                          >= np.linalg.norm(c2 - away_from) else c2)
            # walk the cycle from v, rotating around the center by the
            # polygon's central angle, in the direction consistent with
            # u's position
            out = {u: pu, v: pv}
            ang_u = math.atan2(*(pu - center)[::-1])
            ang_v = math.atan2(*(pv - center)[::-1])
            step = 2.0 * math.pi / m
            # direction: going v -> next should move AWAY from u
            d = (ang_v - ang_u) % (2.0 * math.pi)
            sign = 1.0 if abs(d - step) < abs(d - (2 * math.pi - step)) \
                else -1.0
            ang = ang_v
            for t in range(1, m - 1):
                a = cycle[(idx + t) % m]
                ang += sign * step
                if a not in out:
                    out[a] = center + r * np.array([math.cos(ang),
                                                    math.sin(ang)])
            return out
    if len(pinned) == 1:
        u = pinned[0]
        pu = fixed[u]
        if away_from is None:
            direction = np.array([1.0, 0.0])
        else:
            direction = pu - away_from
            direction = direction / (np.linalg.norm(direction) + 1e-12)
        center = pu + direction * r
    else:
        u = cycle[0]
        center = np.zeros(2)
        pu = center + r * np.array([1.0, 0.0])
    out = {}
    idx = cycle.index(u)
    ang0 = math.atan2(*(pu - center)[::-1])
    step = 2.0 * math.pi / m
    for t in range(m):
        a = cycle[(idx + t) % m]
        ang = ang0 + t * step
        out[a] = center + r * np.array([math.cos(ang), math.sin(ang)])
    out[u] = pu
    return out


def _bicyclo_decompose(rings: List[List[int]],
                       sys_rings: List[int]):
    """Detect a bicyclo[x.y.z] (x,y,z >= 1) bridged system: exactly two
    ring atoms of ring-degree 3 (the bridgeheads) joined by three
    disjoint simple bridges.  Returns (B1, B2, [bridge paths ordered
    B1 -> B2, longest first]) or None (ortho-fused systems have a
    length-0 bridge and keep the shared-edge reflection path;
    >2-bridgehead cages like adamantane keep the relaxation repair)."""
    edges: Set[frozenset] = set()
    atoms: Set[int] = set()
    for ri in sys_rings:
        atoms |= set(rings[ri])
        edges |= set(_edge_set(rings[ri]))
    adj: Dict[int, List[int]] = {a: [] for a in atoms}
    for e in edges:
        a, b = tuple(e)
        adj[a].append(b)
        adj[b].append(a)
    heads = [a for a in atoms if len(adj[a]) == 3]
    if len(heads) != 2 or any(len(adj[a]) > 3 for a in atoms):
        return None
    b1, b2 = heads
    if b2 in adj[b1]:
        return None  # direct bond = ortho-fused, not bridged
    bridges = []
    for start in adj[b1]:
        path = [start]
        prev, cur = b1, start
        while cur != b2:
            nxt = [w for w in adj[cur] if w != prev]
            if len(nxt) != 1:
                return None
            prev, cur = cur, nxt[0]
            if cur != b2:
                path.append(cur)
            if len(path) > len(atoms):
                return None
        bridges.append(path)
    if len(bridges) != 3 or any(not p for p in bridges):
        return None
    seen = [a for p in bridges for a in p]
    if len(seen) != len(set(seen)) or set(seen) | {b1, b2} != atoms:
        return None
    bridges.sort(key=len, reverse=True)
    return b1, b2, bridges


def _bridged_template(rings: List[List[int]], sys_rings: List[int],
                      pos: Dict[int, np.ndarray],
                      away_hint: Optional[np.ndarray]) -> bool:
    """Template placement for bicyclo[x.y.z] cores (norbornane,
    bicyclo[2.2.2]octane, tropane — VERDICT round-4 item 9): the two
    longest bridges + bridgeheads form the perimeter polygon; the
    shortest bridge is drawn ACROSS the interior with a perpendicular
    bow (the classic norbornane apex).  Rigidly aligned to any
    pre-placed member atoms.  Returns True when applied."""
    dec = _bicyclo_decompose(rings, sys_rings)
    if dec is None:
        return False
    b1, b2, (br1, br2, br3) = dec
    perimeter = [b1] + br1 + [b2] + br2[::-1]
    local = _polygon_positions(perimeter, {}, None)
    center = np.mean([local[a] for a in perimeter], axis=0)
    p1, p2 = local[b1], local[b2]
    chord = p2 - p1
    mid = (p1 + p2) / 2.0
    toward = center - mid
    tn = np.linalg.norm(toward)
    if tn < 1e-9:  # bridgeheads antipodal: bow to a fixed side
        toward = np.array([-chord[1], chord[0]])
        tn = np.linalg.norm(toward) + 1e-9
    toward = toward / tn
    n3 = len(br3)
    for k, a in enumerate(br3, start=1):
        t = k / (n3 + 1.0)
        bow = 0.45 * math.sin(math.pi * t)
        local[a] = p1 + t * chord + bow * toward
    # rigid alignment to pre-placed pins (Kabsch for >= 2 pins)
    pinned = [a for a in local if a in pos]
    if len(pinned) >= 2:
        A = np.stack([local[a] for a in pinned])
        B = np.stack([pos[a] for a in pinned])
        ca, cb = A.mean(0), B.mean(0)
        H = (A - ca).T @ (B - cb)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, d]) @ U.T
        for a, p in local.items():
            local[a] = R @ (p - ca) + cb
    elif len(pinned) == 1:
        a0 = pinned[0]
        if away_hint is not None:
            # rotate so the template centroid lies on the FAR side of
            # the pinned atom from the rest of the molecule
            d = (np.mean([p for p in local.values()], axis=0)
                 - local[a0])
            dn = np.linalg.norm(d)
            want = pos[a0] - away_hint
            wn = np.linalg.norm(want)
            if dn > 1e-9 and wn > 1e-9:
                ca = math.atan2(d[1], d[0])
                wa = math.atan2(want[1], want[0])
                th = wa - ca
                R = np.array([[math.cos(th), -math.sin(th)],
                              [math.sin(th), math.cos(th)]])
                for a, p in local.items():
                    local[a] = R @ (p - local[a0])
                local = {a: p for a, p in local.items()}
        shift = pos[a0] - local[a0]
        for a, p in local.items():
            local[a] = p + shift
    for a, p in local.items():
        if a not in pos:
            pos[a] = p
    return True


def _place_ring_system(rings: List[List[int]], sys_rings: List[int],
                       pos: Dict[int, np.ndarray],
                       away_hint: Optional[np.ndarray] = None) -> None:
    """Place every ring of one fused system: BFS over rings, each new
    ring reflected to the far side of what is already placed.
    ``away_hint`` (the attaching chain atom's position) orients the
    FIRST ring away from the rest of the molecule.  Bicyclo[x.y.z]
    bridged systems take the template path instead
    (:func:`_bridged_template`)."""
    if len(sys_rings) > 1 and _bridged_template(rings, sys_rings, pos,
                                                away_hint):
        return
    todo = list(sys_rings)
    placed_rings: List[int] = []
    while todo:
        # pick the ring sharing most atoms with current placement
        # (first iteration: the ring with the most pre-placed
        # attachment atoms)
        todo.sort(key=lambda ri: -sum(1 for a in rings[ri] if a in pos))
        ri = todo.pop(0)
        cycle = rings[ri]
        fixed = {a: pos[a] for a in cycle if a in pos}
        away = None
        if placed_rings:
            neigh = [rj for rj in placed_rings
                     if set(rings[rj]) & set(cycle)]
            if neigh:
                pts = [pos[a] for a in rings[neigh[0]] if a in pos]
                if pts:
                    away = np.mean(pts, axis=0)
        elif fixed:
            away = away_hint
        for a, p in _polygon_positions(cycle, fixed, away).items():
            if a not in pos:
                pos[a] = p
        placed_rings.append(ri)


def _largest_gap_angles(pos: Dict[int, np.ndarray], u: int,
                        nbr_pos: List[np.ndarray], n_new: int,
                        linear: bool,
                        grandparent: Optional[np.ndarray] = None
                        ) -> List[float]:
    """Angles (radians) for ``n_new`` new substituents of atom ``u``,
    spread inside the largest free angular gap around it.
    ``grandparent`` (the parent's previous atom) makes chains ZIGZAG:
    the new bond goes to the side of the u-parent axis OPPOSITE the
    grandparent (trans), instead of always turning the same way —
    which would curl a hexane chain into a closed hexagon."""
    pu = pos[u]
    angles = sorted(math.atan2(*(p - pu)[::-1]) for p in nbr_pos)
    if not angles:
        return [k * 2.0 * math.pi / max(n_new, 1) for k in range(n_new)]
    if linear and len(angles) == 1 and n_new == 1:
        return [angles[0] + math.pi]
    if len(angles) == 1 and n_new == 1:
        # standard 120-degree chain geometry: two candidate sides
        cand = [angles[0] + math.pi - math.pi / 3.0,
                angles[0] + math.pi + math.pi / 3.0]
        if grandparent is None:
            return [cand[0]]
        # trans zigzag: take the side farther from the grandparent
        pts = [pu + np.array([math.cos(a), math.sin(a)]) for a in cand]
        d = [np.linalg.norm(p - grandparent) for p in pts]
        return [cand[0] if d[0] >= d[1] else cand[1]]
    gaps = []
    for i in range(len(angles)):
        a0 = angles[i]
        a1 = angles[(i + 1) % len(angles)] + (2.0 * math.pi
                                              if i + 1 == len(angles)
                                              else 0.0)
        gaps.append((a1 - a0, a0, a1))
    width, a0, a1 = max(gaps)
    return [a0 + width * (k + 1) / (n_new + 1) for k in range(n_new)]


def _collides(pos: Dict[int, np.ndarray], p: np.ndarray,
              ignore: Set[int], thresh: float = 0.55) -> bool:
    return any(np.linalg.norm(p - q) < thresh
               for a, q in pos.items() if a not in ignore)


def layout2d(mol: Mol) -> np.ndarray:
    """Chemistry-standard coordinates for every atom, scaled to [-1, 1]."""
    n = mol.num_atoms()
    if n == 0:
        return np.zeros((0, 2), np.float32)
    if n == 1:
        return np.zeros((1, 2), np.float32)
    rings = _small_rings(mol)
    systems = _ring_systems(rings)
    atom_system: Dict[int, int] = {}
    for si, sys_rings in enumerate(systems):
        for ri in sys_rings:
            for a in rings[ri]:
                atom_system.setdefault(a, si)
    neighbors: List[List[int]] = [[] for _ in range(n)]
    bond_order: Dict[Tuple[int, int], int] = {}
    for b in mol.bonds:
        neighbors[b.a].append(b.b)
        neighbors[b.b].append(b.a)
        bond_order[(b.a, b.b)] = bond_order[(b.b, b.a)] = b.order

    def is_linear_center(u: int) -> bool:
        # sp centers draw collinear: any triple bond, or a 2-neighbor
        # atom with two double bonds (allene middle)
        orders = [bond_order[(u, v)] for v in neighbors[u]]
        return (any(o == TRIPLE for o in orders)
                or (len(orders) == 2 and orders.count(2) == 2))

    pos: Dict[int, np.ndarray] = {}
    placed_systems: Set[int] = set()
    components: List[List[int]] = []
    seen: Set[int] = set()
    for start in range(n):
        if start in seen:
            continue
        comp = [start]
        seen.add(start)
        qi = 0
        while qi < len(comp):
            u = comp[qi]
            qi += 1
            for v in neighbors[u]:
                if v not in seen:
                    seen.add(v)
                    comp.append(v)
        components.append(comp)

    comp_coords: List[Dict[int, np.ndarray]] = []
    for comp in components:
        pos = {}
        placed_systems = set()
        # seed: a ring-system atom if any, else the first atom
        seed = next((a for a in comp if a in atom_system), comp[0])
        if seed in atom_system:
            si = atom_system[seed]
            _place_ring_system(rings, systems[si], pos)
            placed_systems.add(si)
        else:
            pos[seed] = np.zeros(2)
        # BFS placement over the component
        frontier = [a for a in comp if a in pos]
        qi = 0
        while qi < len(frontier):
            u = frontier[qi]
            qi += 1
            new = [v for v in neighbors[u] if v not in pos]
            if not new:
                continue
            # ring-system members of u handled during system placement;
            # if v belongs to an UNPLACED system, place v then its system
            placed_nb = [v for v in neighbors[u] if v in pos]
            nbr_pos = [pos[v] for v in placed_nb]
            gp = None
            if len(placed_nb) == 1:
                w = placed_nb[0]
                others = [x for x in neighbors[w]
                          if x != u and x in pos]
                if others:
                    gp = pos[others[0]]
            angs = _largest_gap_angles(pos, u, nbr_pos, len(new),
                                       is_linear_center(u),
                                       grandparent=gp)
            for v, ang in zip(new, angs):
                p = pos[u] + BOND * np.array([math.cos(ang),
                                              math.sin(ang)])
                if _collides(pos, p, {u, v}):
                    # try a fan of alternates, keep the farthest-
                    # from-everything candidate
                    best, best_d = p, -1.0
                    for off in (math.pi / 3, -math.pi / 3,
                                2 * math.pi / 3, -2 * math.pi / 3,
                                math.pi):
                        q = pos[u] + BOND * np.array(
                            [math.cos(ang + off), math.sin(ang + off)])
                        d = min((np.linalg.norm(q - w)
                                 for a2, w in pos.items() if a2 != u),
                                default=1e9)
                        if d > best_d:
                            best, best_d = q, d
                    if best_d > 0.55:
                        p = best
                pos[v] = p
                si = atom_system.get(v)
                if si is not None and si not in placed_systems:
                    before = set(pos)
                    _place_ring_system(rings, systems[si], pos,
                                       away_hint=pos[u])
                    placed_systems.add(si)
                    # every ring atom the system placement added must
                    # join the frontier, or their substituents would
                    # never be placed
                    frontier.extend(a for a in pos if a not in before)
                frontier.append(v)
        comp_coords.append(pos)

    # repair pass: topologies beyond the constructive rules (bridged
    # polycyclics, ring systems reached from two chain paths) can leave
    # collisions or stretched ring-closure bonds.  Detect and fix with
    # a CONSTRAINED relaxation seeded from the chemistry layout — bond
    # springs toward unit length plus short-range repulsion — which
    # leaves already-clean components untouched.
    bonded_pairs = {(b.a, b.b) for b in mol.bonds}
    bonded_pairs |= {(b.b, b.a) for b in mol.bonds}
    for pos in comp_coords:
        atoms = sorted(pos)
        if len(atoms) < 3:
            continue
        idx = {a: k for k, a in enumerate(atoms)}
        P = np.stack([pos[a] for a in atoms])
        comp_bonds = [(idx[b.a], idx[b.b]) for b in mol.bonds
                      if b.a in idx and b.b in idx]

        def _bad(P):
            bl = [np.linalg.norm(P[i] - P[j]) for i, j in comp_bonds]
            dmin = min((np.linalg.norm(P[i] - P[j])
                        for i in range(len(atoms))
                        for j in range(i + 1, len(atoms))
                        if (atoms[i], atoms[j]) not in bonded_pairs),
                       default=np.inf)
            return (bl and (max(bl) > 1.6 * BOND
                            or min(bl) < 0.6 * BOND)) or dmin < 0.4 * BOND

        if not _bad(P):
            continue
        rng = np.random.RandomState(0)
        for it in range(300):
            F = np.zeros_like(P)
            for i, j in comp_bonds:
                d = P[j] - P[i]
                dist = np.linalg.norm(d) + 1e-9
                f = 0.5 * (dist - BOND) * d / dist
                F[i] += f
                F[j] -= f
            delta = P[:, None, :] - P[None, :, :]
            dist = np.linalg.norm(delta, axis=-1) + 1e-9
            np.fill_diagonal(dist, np.inf)
            with np.errstate(invalid="ignore"):
                rep = np.where(dist < 1.3 * BOND,
                               0.25 * (1.3 * BOND - dist) / dist, 0.0)
            F += (rep[..., None] * delta).sum(axis=1)
            coincident = ~np.isfinite(F).all(axis=1) | (dist.min(1) < 1e-6)
            if coincident.any():
                F[coincident] = rng.randn(int(coincident.sum()), 2)
            step = np.clip(F, -0.15, 0.15)
            P = P + step
            if it % 50 == 49 and not _bad(P):
                break
        for a in atoms:
            pos[a] = P[idx[a]]

    # arrange components side by side with one bond length of margin
    coords = np.zeros((n, 2), np.float64)
    x_cursor = 0.0
    for pos in comp_coords:
        arr = np.stack([pos[a] for a in sorted(pos)])
        lo, hi = arr.min(0), arr.max(0)
        shift = np.array([x_cursor - lo[0], -(lo[1] + hi[1]) / 2.0])
        for a, p in pos.items():
            coords[a] = p + shift
        x_cursor += (hi[0] - lo[0]) + 1.5 * BOND
    coords -= coords.mean(0)
    scale = np.abs(coords).max() + 1e-9
    return (coords / scale).astype(np.float32)
