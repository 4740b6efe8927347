"""Canonical (spelling-invariant) stereo descriptors for molecule identity,
a verbatim copy of the JAX package's ``chem/stereo.py``.

The reference dedups molecules via RDKit canonical SMILES with
``isomericSmiles=True`` (reference src_1gp/dataset.py:154,
src_2gi_dti_scr/dataset.py:162,192; the DDI store normalization at
src_2gi_ddi/dataset.py:118-124), so stereoisomers are DISTINCT
identities.  Features stay stereo-free (the 15-dim layout has no stereo
columns, src_1gp/dataset.py:60-97) and the scaffold split ignores
chirality (``includeChirality=False``, src_1gp/utils.py:31-39) — only
:func:`glam_tpu_torch.chem.scaffold.molecule_key` consumes these descriptors.

A SMILES chiral tag ('@'/'@@') is defined relative to the AS-WRITTEN
neighbor order, so the raw tag is not spelling-invariant: swapping two
neighbors in the writing flips it.  Canonicalization re-expresses each
tag relative to a canonical neighbor order (sorted by Weisfeiler-Lehman
refined labels): permutation parity between the written and canonical
orders decides whether the tag flips.  Likewise '/'+'\\' directional
bonds are re-expressed as a cis/trans flag for the highest-ranked
substituent pair across each double bond.

Limitations (documented, shared with one-pass canonical ranking):
stereocenters whose neighbors are WL-equivalent (meso-style local
symmetry, or stereo-dependent ranks) yield no descriptor and fall back
to the stereo-free identity.
"""
from __future__ import annotations

import hashlib
from collections import defaultdict
from typing import Dict, List, Tuple

from .smiles import CHIRAL_NONE, DOUBLE, SINGLE, Mol


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


def _parity(keys: List[str]) -> int:
    """Parity (0 even / 1 odd) of the permutation sorting ``keys``."""
    inv = 0
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            if keys[i] > keys[j]:
                inv += 1
    return inv & 1


def tetrahedral_descriptors(mol: Mol,
                            ranks: Dict[int, str]) -> Dict[int, int]:
    """Canonical chiral tag per stereocenter: {atom index: 1 or 2}.

    1/2 correspond to '@'/'@@' re-expressed against neighbors sorted by
    WL rank (implicit H ranks as '~H', a 3-neighbor lone pair as '~LP',
    both sorting before any md5 rank).  Atoms whose neighbors are not
    all WL-distinct are skipped.
    """
    out: Dict[int, int] = {}
    for i, atom in enumerate(mol.atoms):
        if atom.chiral == CHIRAL_NONE:
            continue
        order = list(atom.written_nbrs)
        if any(x < -1 for x in order):  # unresolved ring placeholder
            continue
        nh = atom.explicit_h or 0
        if nh > 1:
            continue
        if nh == 1:
            # Daylight: the implicit H occupies the position right after
            # the preceding atom, or first if the atom opens the SMILES
            order.insert(1 if atom.first_nbr_is_prev else 0, -1)
        if len(order) == 3:
            order.append(-9)  # lone pair acts as the 4th, lowest neighbor
        if len(order) != 4:
            continue
        keys = [("~H" if x == -1 else "~LP") if x < 0 else ranks[x]
                for x in order]
        if len(set(keys)) != 4:
            continue  # locally symmetric: no canonical descriptor
        tag = atom.chiral if _parity(keys) == 0 else (3 - atom.chiral)
        out[i] = tag
    return out


def allene_descriptors(mol: Mol, ranks: Dict[int, str]) -> Dict[int, int]:
    """Canonical axial-chirality tag per @AL-tagged allene center:
    {center atom index: 1 or 2}.

    OpenSMILES defines @AL1/@AL2 as EXTENDED TETRAHEDRAL: the four
    neighbor slots are the substituents of the two double-bond termini
    in order of appearance, interpreted exactly like '@'/'@@'
    (@AL1 = anticlockwise).  Canonicalization therefore reuses the
    tetrahedral machinery: permutation parity between the as-written
    substituent order (implicit H occupying its terminus's written
    slot) and the WL-rank-sorted order re-expresses the tag
    spelling-invariantly.  Substituent keys are tie-broken by their
    terminus's rank, so the H atoms of a 1,3-disubstituted allene
    (X-CH=C=CH-Y, X != Y) stay distinguishable.

    SYMMETRIC 1,3-disubstituted allenes (penta-2,3-diene,
    1,3-difluoroallene — the most common chiral-allene pattern, ADVICE
    round-4) get a final tie-break by terminus APPEARANCE order: when
    the two termini's (substituent rank, terminus rank) pairs tie
    PAIRWISE, reversing the traversal swaps both tied pairs at once —
    an even permutation — so the written-vs-canonical parity stays
    spelling-invariant and the enantiomers resolve.  A PARTIAL
    cross-terminus tie (one pair tied, the other not — only reachable
    through WL-rank collisions on non-symmetric graphs) would make the
    appearance tie-break odd under traversal reversal, so those stay
    dropped.

    Centers that cannot be canonicalized (a terminus with two
    WL-equal substituents — genuinely non-stereogenic, partial ties
    as above, ring-closure placeholders, >1 H on a terminus) are
    COUNTED as dropped via the exotic-stereo counter — the merge is
    never silent."""
    from .smiles import _record_exotic_stereo
    out: Dict[int, int] = {}
    for i, atom in enumerate(mol.atoms):
        exo = atom.exotic_chiral
        if not exo.startswith("AL"):
            continue
        tag = {"AL1": 1, "AL2": 2}.get(exo, 0)
        termini = [mol.bonds[bi].other(i) for bi in atom.bonds
                   if mol.bonds[bi].order == DOUBLE]
        keys = []
        ok = tag != 0 and len(termini) == 2
        if ok:
            for tid, t in enumerate(termini):
                ta = mol.atoms[t]
                lst = list(ta.written_nbrs)
                if any(x < -1 for x in lst):  # unresolved ring slot
                    ok = False
                    break
                nh = (ta.explicit_h or 0) if ta.in_bracket else ta.num_h
                if nh > 1:
                    ok = False
                    break
                if nh == 1:
                    lst.insert(1 if ta.first_nbr_is_prev else 0, -1)
                subs = [x for x in lst if x != i]
                if len(subs) != 2:
                    ok = False
                    break
                for x in subs:
                    keys.append(("~H" if x == -1 else ranks[x],
                                 ranks[t], tid))
        if ok:
            two = [(k[0], k[1]) for k in keys]  # rank pair, no tid
            if two[0] == two[1] or two[2] == two[3]:
                ok = False  # within-terminus tie: not stereogenic
            elif len(set(two)) == 4:
                pass        # fully distinct: tid never consulted
            elif sorted(two[:2]) == sorted(two[2:]):
                pass        # fully symmetric termini: tid breaks evenly
            else:
                ok = False  # partial cross-tie: parity not stable
        if ok:
            out[i] = tag if _parity(keys) == 0 else (3 - tag)
        else:
            _record_exotic_stereo("AL")
    return out


_SP_TRANS = {
    # OpenSMILES square-planar classes name the SHAPE the four listed
    # neighbors trace on the square; the geometric content is which
    # listed slots are TRANS (diagonal):
    #   @SP1 'U' (perimeter order)  -> (0,2), (1,3)
    #   @SP2 '4'                    -> (0,1), (2,3)
    #   @SP3 'Z' (zigzag)           -> (0,3), (1,2)
    # (the three classes are exactly the three perfect matchings of the
    # four slots — OpenSMILES spec example C[Pt@SP1](F)(Cl)[H] puts C
    # trans to Cl, confirming the U mapping)
    "SP1": ((0, 2), (1, 3)),
    "SP2": ((0, 1), (2, 3)),
    "SP3": ((0, 3), (1, 2)),
}


def square_planar_descriptors(mol: Mol,
                              ranks: Dict[int, str]) -> Dict[int, str]:
    """Canonical square-planar descriptor per @SP-tagged center:
    {atom index: string}.

    A square-planar arrangement is fully characterized by its
    TRANS-pairing (which two pairs of ligands sit diagonal) — the three
    @SP classes are the three possible pairings, and every respelling
    of one arrangement maps (order permutation + class change) to the
    SAME pairing.  The canonical descriptor is therefore the sorted
    multiset of sorted (WL rank, WL rank) trans pairs — spelling-
    invariant by construction, and it distinguishes cis/trans
    isomerism with WL-tied equivalent ligands (cisplatin
    N[Pt@SP1](N)(Cl)Cl vs transplatin N[Pt@SP1](Cl)(N)Cl) where an
    all-ranks-distinct requirement would fail.  Limitation (shared
    with tetrahedral WL ranking): substituents that are WL-tied
    without being graph-equivalent could merge distinct isomers —
    a WL-collision class not observed in practice.

    Centers that cannot be canonicalized (not exactly 4 neighbor
    slots, unresolved ring placeholder, >1 implicit H) are COUNTED via
    the exotic-stereo counter."""
    from .smiles import _record_exotic_stereo
    out: Dict[int, str] = {}
    for i, atom in enumerate(mol.atoms):
        exo = atom.exotic_chiral
        if not exo.startswith("SP"):
            continue
        trans = _SP_TRANS.get(exo)
        order = list(atom.written_nbrs)
        ok = trans is not None and not any(x < -1 for x in order)
        if ok:
            nh = atom.explicit_h or 0
            if nh > 1:
                ok = False
            elif nh == 1:
                order.insert(1 if atom.first_nbr_is_prev else 0, -1)
        if ok and len(order) == 4:
            keys = ["~H" if x == -1 else ranks[x] for x in order]
            pairs = sorted(
                "+".join(sorted((keys[a], keys[b]))) for a, b in trans)
            out[i] = "|".join(pairs)
        else:
            _record_exotic_stereo("SP")
    return out


def double_bond_descriptors(mol: Mol,
                            ranks: Dict[int, str]) -> Dict[int, str]:
    """Canonical cis/trans flag per configured double bond:
    {bond index: 'c' | 't'} for the highest-WL-ranked substituent pair.
    """
    out: Dict[int, str] = {}
    for bi, b in enumerate(mol.bonds):
        if b.order != DOUBLE:
            continue

        def side(center: int, away: int):
            """(best substituent, its direction sign INTO the axis,
            ok) for one side of the double bond.  Direction sign of a
            substituent bond x-center is normalized to 'ascending from
            x to center'; the two substituents of one sp2 center always
            carry opposite signs."""
            subs = []       # (rank, atom, dir ascending sub -> center)
            for bj in mol.atoms[center].bonds:
                nb = mol.bonds[bj]
                x = nb.other(center)
                if x == away and nb.order == DOUBLE:
                    continue
                if nb.order != SINGLE:
                    return None  # other multiple bond: not a C=C stereo
                d = nb.direction
                if d != 0:
                    d = d if nb.b == center else -d
                subs.append((ranks[x], x, d))
            if not (1 <= len(subs) <= 2):
                return None
            if len(subs) == 2 and subs[0][0] == subs[1][0]:
                return None  # symmetric side: not stereogenic
            configured = [s for s in subs if s[2] != 0]
            if not configured:
                return None  # no directional bond on this side
            if (len(configured) == 2
                    and configured[0][2] == configured[1][2]):
                # contradictory directions (both substituents on the
                # same side — geometrically impossible): drop the
                # descriptor rather than resolving written-order
                # dependently, matching RDKit's conflicting-bond-
                # direction handling, so respellings keep ONE key
                return None
            best = max(subs)
            d0 = configured[0][2]
            # the OTHER substituent of the same center sits on the
            # opposite side: flip if the directional bond isn't best's
            d_best = d0 if best[1] == configured[0][1] else -d0
            return best[1], d_best

        sa = side(b.a, b.b)
        sb = side(b.b, b.a)
        if sa is None or sb is None:
            continue
        # trans iff dir(x -> a) == dir(b -> y); side() yields dir INTO
        # the center on both sides, so flip one sign
        out[bi] = "t" if sa[1] == -sb[1] else "c"
    return out
