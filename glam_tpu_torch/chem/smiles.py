"""A self-contained SMILES parser producing molecular graphs.

The reference delegates all chemistry to RDKit's C++ toolkit
(reference src_1gp/dataset.py:14-24).  RDKit is not available in this
environment, so this module implements the subset of chemistry the
framework needs from first principles:

  * full SMILES grammar: organic subset + bracket atoms, charges, isotopes,
    explicit H counts, ring closures (incl. %nn), branches, all bond
    symbols, dot-disconnections, chirality tags (``@``/``@@`` incl.
    ``@TH1/2`` — recorded with the as-written neighbor order and made
    spelling-invariant by the JAX package's ``chem/stereo.py``; they are
    LOAD-BEARING for molecule identity, see ``molecule_key``),
    directional bonds (``/`` ``\\`` — single bond order, orientation
    recorded for cis/trans identity),
  * implicit hydrogen counting via standard valences,
  * aromatic ring perception for Kekulé-written rings (Hückel 4n+2 over
    candidate rings) so `C1=CC=CC=C1` and `c1ccccc1` featurize identically,
  * hybridization assignment (SP/SP2/SP3) from steric number,
    matching RDKit's assignments on common organic molecules.

The output :class:`Mol` is a plain python graph; featurization to arrays
lives in :mod:`glam_tpu_torch.chem.featurize`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# Bond orders: aromatic bonds count 1.5 toward valence.
SINGLE, DOUBLE, TRIPLE, AROMATIC = 1, 2, 3, 4
_BOND_ORDER = {SINGLE: 1.0, DOUBLE: 2.0, TRIPLE: 3.0, AROMATIC: 1.5}

# Default valences (smallest first) for implicit-H computation, Daylight model.
_VALENCES = {
    "B": (3,), "C": (4,), "N": (3,), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
    "H": (1,),
}

# Maximum permitted valence per element for input sanitization — the
# RDKit default-valence table (maximum of each valence list).  RDKit
# REJECTS molecules whose explicit valence exceeds this (Atom.cpp
# calculateExplicitValence), and the reference SKIPS such rows
# (reference src_1gp/dataset.py:129,151-158 is_valid_smiles), so
# accepting them here would silently change dataset membership on dirty
# real corpora.  Elements absent from this table (most metals, '*') are
# unchecked, like RDKit's -1 ("no limit") entries.
_MAX_VALENCE = {
    "H": 1, "He": 0, "Li": 1, "Be": 2, "B": 3, "C": 4, "N": 3, "O": 2,
    "F": 1, "Ne": 0, "Na": 1, "Mg": 2, "Al": 3, "Si": 4, "P": 5, "S": 6,
    "Cl": 1, "Ar": 0, "K": 1, "Ca": 2, "Ga": 3, "Ge": 4, "As": 5,
    "Se": 6, "Br": 1, "Kr": 0, "Rb": 1, "Sr": 2, "Te": 6, "I": 1,
    "Xe": 0, "Cs": 1, "Ba": 2,
}

_ATOMIC_NUM = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Cr": 24, "Mn": 25,
    "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30, "Ga": 31, "Ge": 32,
    "As": 33, "Se": 34, "Br": 35, "Kr": 36, "Rb": 37, "Sr": 38, "Mo": 42,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "Pt": 78,
    "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83,
}

# Valence electrons by main group (for lone-pair / hybridization estimate).
_VALENCE_ELECTRONS = {
    "H": 1, "B": 3, "C": 4, "Si": 4, "N": 5, "P": 5, "As": 5,
    "O": 6, "S": 6, "Se": 6, "Te": 6, "F": 7, "Cl": 7, "Br": 7, "I": 7,
}

SP, SP2, SP3, OTHER_HYB = 1, 2, 3, 0


CHIRAL_NONE, CHIRAL_CCW, CHIRAL_CW = 0, 1, 2  # none / '@' / '@@'

# ---------------------------------------------------------------------------
# Exotic stereo classes: @AL (allene axial chirality) is CANONICALIZED
# like tetrahedral tags (chem/stereo.py:allene_descriptors — extended
# tetrahedral per OpenSMILES), with unresolvable centers counted here.
# @SP/@TB/@OH (square-planar / trigonal-bipyramidal / octahedral) carry
# no canonical descriptor, so molecules differing only in such a tag
# merge into ONE identity — unlike the reference's isomericSmiles=True
# dedup (reference src_2gi_ddi/dataset.py:118-124).  The merge is
# rare in drug corpora but must not be silent: every dropped tag is
# counted here and warned about once per class; dataset loaders print
# the corpus total so reports show how many identities merged.
_EXOTIC_STEREO_RE = re.compile(r"@(AL|SP|TB|OH)\d+$")
_exotic_stereo_counts: Dict[str, int] = {}


def _record_exotic_stereo(cls: str) -> None:
    import warnings
    _exotic_stereo_counts[cls] = _exotic_stereo_counts.get(cls, 0) + 1
    warnings.warn(
        f"SMILES @{cls} stereo tag has no canonical descriptor and is "
        "DROPPED for molecule identity: stereoisomers differing only "
        "in this tag merge into one key (counted; see "
        "exotic_stereo_counts())", UserWarning, stacklevel=4)


def exotic_stereo_counts() -> Dict[str, int]:
    """Per-class count of exotic stereo tags dropped since the last
    :func:`reset_exotic_stereo_counts` (corpus-report surface)."""
    return dict(_exotic_stereo_counts)


def reset_exotic_stereo_counts() -> None:
    _exotic_stereo_counts.clear()


@dataclass
class Atom:
    symbol: str                 # element symbol, e.g. 'Cl'
    aromatic: bool = False
    charge: int = 0
    explicit_h: Optional[int] = None   # from bracket; None => implicit
    isotope: int = 0
    in_bracket: bool = False
    bonds: List[int] = field(default_factory=list)   # bond indices
    # tetrahedral stereo: '@' = CHIRAL_CCW, '@@' = CHIRAL_CW, interpreted
    # against the AS-WRITTEN neighbor order below (Daylight semantics);
    # canonicalization lives in chem/stereo.py.  Features stay
    # stereo-free (the reference's 15-dim layout has no stereo columns,
    # src_1gp/dataset.py:60-97); only identity keys consume these.
    chiral: int = CHIRAL_NONE
    # extended-tetrahedral (allene) tag: "AL1"/"AL2", canonicalized by
    # chem/stereo.py:allene_descriptors (SP/TB/OH classes stay dropped
    # loudly — see _record_exotic_stereo)
    exotic_chiral: str = ""
    written_nbrs: List[int] = field(default_factory=list)
    first_nbr_is_prev: bool = False    # True if written_nbrs[0] is the
    #                                    preceding atom (H-insert rule)
    # filled by finalize():
    num_h: int = 0
    hybridization: int = OTHER_HYB
    in_ring: bool = False

    @property
    def atomic_num(self) -> int:
        return _ATOMIC_NUM.get(self.symbol, 0)


@dataclass
class Bond:
    a: int
    b: int
    order: int  # SINGLE/DOUBLE/TRIPLE/AROMATIC
    # directional single bond ('/' = +1, '\' = -1, none = 0), oriented
    # as written FROM a TO b: +1 means the bond ascends a -> b.  Used
    # only for double-bond cis/trans identity (chem/stereo.py).
    direction: int = 0

    def other(self, i: int) -> int:
        return self.b if i == self.a else self.a


@dataclass
class Mol:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)

    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[int]:
        return [self.bonds[bi].other(i) for bi in self.atoms[i].bonds]


class SmilesError(ValueError):
    pass


_BRACKET_RE = re.compile(
    r"^(?P<iso>\d+)?(?P<sym>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chiral>@{1,2}(?:TH\d|AL\d|SP\d|TB\d+|OH\d+)?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$")

_TWO_LETTER = {"Cl", "Br", "Si", "Se", "As", "Na", "Li", "Mg", "Ca", "Al",
               "Fe", "Zn", "Cu", "Mn", "Sn", "Pb", "Hg", "Pt", "Au", "Ag",
               "Cd", "Cr", "Co", "Ni", "Ba", "Bi", "Sr", "Tl", "Te", "Sb",
               "In", "Ge", "Ga", "Mo", "Ru", "Rh", "Pd", "Kr", "Xe", "Rb",
               "Cs", "Be", "Ne", "Ar", "He"}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_BOND_CHARS = {"-": SINGLE, "=": DOUBLE, "#": TRIPLE, ":": AROMATIC,
               "/": SINGLE, "\\": SINGLE, "$": 4}


def _parse_bracket(body: str) -> Atom:
    m = _BRACKET_RE.match(body)
    if not m:
        raise SmilesError(f"bad bracket atom [{body}]")
    sym = m.group("sym")
    aromatic = sym[0].islower() and sym != "*"
    if aromatic:
        sym = sym.capitalize()
    hc = m.group("hcount")
    if hc is None:
        explicit_h = 0
    elif hc == "H":
        explicit_h = 1
    else:
        explicit_h = int(hc[1:])
    ch = m.group("charge") or ""
    if ch.startswith("+"):
        charge = int(ch[1:]) if ch[1:].isdigit() else len(ch)
    elif ch.startswith("-"):
        charge = -int(ch[1:]) if ch[1:].isdigit() else -len(ch)
    else:
        charge = 0
    chi = m.group("chiral") or ""
    exotic = ""
    if chi.startswith("@@") or chi in ("@TH2",):
        chiral = CHIRAL_CW
    elif chi in ("@", "@TH1"):
        chiral = CHIRAL_CCW
    else:
        chiral = CHIRAL_NONE
        em = _EXOTIC_STEREO_RE.match(chi)
        if em:
            if em.group(1) in ("AL", "SP"):
                # allene axial / square-planar tags: recorded and
                # CANONICALIZED (chem/stereo.py allene_descriptors /
                # square_planar_descriptors); unresolvable centers are
                # counted there, at identity time
                exotic = chi[1:]  # e.g. "AL1", "SP2"
            else:  # @TB/@OH: dropped LOUDLY (counted + warned)
                _record_exotic_stereo(em.group(1))
    return Atom(symbol=sym if sym != "*" else "*", aromatic=aromatic,
                charge=charge, explicit_h=explicit_h, chiral=chiral,
                exotic_chiral=exotic,
                isotope=int(m.group("iso") or 0), in_bracket=True)


def _validate_valence(mol: Mol, written_orders: List[int]) -> None:
    """RDKit-parity valence sanitization (default ON, mirrored
    byte-exactly by native/csrc/glam_native.cpp).

    Deliberately SELF-CONTAINED — it recomputes a conservative valence
    from the AS-WRITTEN bond orders instead of consuming each
    implementation's internal ``num_h``, so the Python oracle and the
    C++ twin cannot drift in accept/reject behavior:

      * written aromatic bonds contribute 1 (the minimal Kekulé
        contribution — an aromatic atom may legitimately carry one more
        ring double bond, so this under-counts by at most 1 and never
        over-rejects valid aromatic systems);
      * implicit H uses the Daylight smallest-sufficient-valence rule on
        that sum, which by construction never exceeds the element
        maximum — so only brackets (explicit H) and raw bond sums can;
      * RDKit's isoelectronic charge rule: elements with >= 4 outer
        electrons check valence - charge, electropositive ones
        valence + charge (so [NH4+], [BH4-], [O-] all pass).

    Known remaining deltas vs RDKit sanitization (documented, accepted):
      * the kekulization check (:func:`_validate_kekulizable`) uses a
        perfect-matching criterion, so even-membered antiaromatic
        spellings that still kekulize (e.g. ``c1ccc1``) are accepted
        where RDKit also runs aromaticity re-perception;
      * aromatic atoms use the minimal-Kekulé model above, so an
        aromatic atom whose every Kekulé structure is hypervalent
        could slip through;
      * no radical/spin accounting (RDKit does none at parse either).
    """
    for i, atom in enumerate(mol.atoms):
        limit = _MAX_VALENCE.get(atom.symbol)
        if limit is None or atom.symbol == "*":
            continue
        wsum = 0.0
        for bi in atom.bonds:
            o = written_orders[bi]
            wsum += 1.0 if o == AROMATIC else _BOND_ORDER[o]
        need = int(-(-wsum // 1))  # ceil
        if atom.in_bracket:
            h = atom.explicit_h or 0
        else:
            h = 0
            for v in _VALENCES.get(atom.symbol, ()):
                if v >= need:
                    h = v - need
                    break
        valence = need + h
        ve = _VALENCE_ELECTRONS.get(atom.symbol, 0)
        effective = valence - atom.charge if ve >= 4 \
            else valence + atom.charge
        if effective > limit:
            raise SmilesError(
                f"valence {effective} on atom {i} ({atom.symbol}, "
                f"charge {atom.charge:+d}) exceeds the permitted "
                f"{limit} (RDKit-parity sanitization)")


def _validate_kekulizable(mol: Mol, written_orders: List[int],
                          written_aromatic: List[bool]) -> None:
    """RDKit-parity kekulization check (mirrored byte-exactly by
    native/csrc/glam_native.cpp).

    An AROMATIC-WRITTEN ring system must admit a Kekulé assignment:
    every aromatic atom that needs a ring double bond must be coverable
    by a perfect matching over the written aromatic bonds.  This is the
    check that rejects the classic dirty-corpus spelling ``n1cccc1``
    (pyrrole missing its ``[nH]``) the way RDKit does ("Can't kekulize
    mol"), so dataset membership matches the reference's skip-row
    behavior.

    Needs-a-double rules (slots = degree + explicit H):
      * C/Si neutral: yes, unless a written exocyclic double/triple
        bond already supplies the pi electron; charged C: no;
      * N/P/As neutral: yes iff slots == 2 (pyridine-type; pyrrole-type
        slots >= 3 donates the lone pair); cation: yes iff slots == 3
        (pyridinium); anion: no (pyrrolide);
      * O/S/Se/Te neutral: no (lone-pair donors); cation: yes
        (pyrylium/thiopyrylium); B: no.

    The matching search is exact backtracking with a step cap; on cap
    overflow the molecule is ACCEPTED (no false rejects).  Documented
    delta vs RDKit: even-membered antiaromatic spellings that still
    kekulize (``c1ccc1``) are accepted here.
    """
    needs: List[int] = []
    for i, atom in enumerate(mol.atoms):
        if not written_aromatic[i]:
            continue
        deg = len(atom.bonds)
        h = atom.explicit_h or 0
        slots = deg + h
        sym, chg = atom.symbol, atom.charge
        exo_multiple = any(
            written_orders[bi] in (DOUBLE, TRIPLE)
            for bi in atom.bonds)
        if sym in ("C", "Si"):
            need = chg == 0 and not exo_multiple
        elif sym in ("N", "P", "As"):
            if chg == 0:
                need = slots == 2 and not exo_multiple
            elif chg > 0:
                need = slots == 3 and not exo_multiple
            else:
                need = False
        elif sym in ("O", "S", "Se", "Te"):
            need = chg > 0
        else:  # B and anything exotic: no pi requirement
            need = False
        if need:
            needs.append(i)
    if not needs:
        return
    need_set = set(needs)
    adj: Dict[int, List[int]] = {i: [] for i in needs}
    for bi, b in enumerate(mol.bonds):
        if written_orders[bi] == AROMATIC and b.a in need_set \
                and b.b in need_set:
            adj[b.a].append(b.b)
            adj[b.b].append(b.a)
    # exact perfect-matching search (molecule ring systems are small);
    # deterministic order keeps the C++ twin byte-identical
    order = sorted(needs, key=lambda i: (len(adj[i]), i))
    steps = [0]

    def match(k: int, used: Set[int]) -> bool:
        steps[0] += 1
        if steps[0] > 100000:
            return True  # cap: accept rather than false-reject
        while k < len(order) and order[k] in used:
            k += 1
        if k == len(order):
            return True
        u = order[k]
        for v in adj[u]:
            if v not in used:
                used.add(u)
                used.add(v)
                if match(k + 1, used):
                    return True
                used.discard(u)
                used.discard(v)
        return False

    if not match(0, set()):
        raise SmilesError(
            "aromatic system cannot be kekulized (RDKit-parity "
            "sanitization): an aromatic atom requires a ring double "
            "bond no Kekulé assignment can provide — e.g. a pyrrole-"
            "type nitrogen written without its [nH]")


def parse_smiles(smiles: str, validate: bool = True) -> Mol:
    """Parse a SMILES string into a :class:`Mol` (H atoms implicit).

    Raises :class:`SmilesError` on malformed input, and (with the
    default ``validate=True``) on chemically impossible valences that
    RDKit's sanitization rejects — so dataset membership matches the
    reference's skip-row behavior on dirty corpora.
    """
    mol = Mol()
    prev: Optional[int] = None
    pending_bond: Optional[int] = None
    pending_dir: int = 0
    stack: List[Tuple[Optional[int], Optional[int]]] = []
    rings: Dict[int, Tuple[int, Optional[int], int, int]] = {}
    i, n = 0, len(smiles)

    def add_atom(atom: Atom) -> int:
        mol.atoms.append(atom)
        return len(mol.atoms) - 1

    def add_bond(a: int, b: int, order: Optional[int],
                 direction: int = 0) -> None:
        if order is None:
            if mol.atoms[a].aromatic and mol.atoms[b].aromatic:
                order = AROMATIC
            else:
                order = SINGLE
        bi = len(mol.bonds)
        mol.bonds.append(Bond(a, b, order, direction=direction))
        mol.atoms[a].bonds.append(bi)
        mol.atoms[b].bonds.append(bi)
        # as-written neighbor order (tetrahedral stereo interpretation)
        mol.atoms[a].written_nbrs.append(b)
        mol.atoms[b].written_nbrs.append(a)

    while i < n:
        c = smiles[i]
        if c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError("unclosed bracket")
            idx = add_atom(_parse_bracket(smiles[i + 1:j]))
            if prev is not None:
                add_bond(prev, idx, pending_bond, pending_dir)
                mol.atoms[idx].first_nbr_is_prev = True
            prev, pending_bond, pending_dir = idx, None, 0
            i = j + 1
        elif c.isalpha() or c == "*":
            # outside brackets only the ORGANIC SUBSET may appear bare:
            # B C N O P S F Cl Br I.  Accepting arbitrary two-letter
            # symbols here would misparse e.g. 'In1cccc1' (iodine +
            # aromatic N ring) as indium.
            if c.isupper() and i + 1 < n and smiles[i:i + 2] in ("Cl",
                                                                 "Br"):
                sym, i = smiles[i:i + 2], i + 2
                atom = Atom(symbol=sym)
            elif c.islower():
                if smiles[i] not in _AROMATIC_ORGANIC:
                    raise SmilesError(f"unexpected atom '{c}' at {i}")
                atom = Atom(symbol=c.upper(), aromatic=True)
                i += 1
            else:
                if c not in "BCNOPSFI*":
                    raise SmilesError(f"unexpected atom '{c}' at {i}")
                atom = Atom(symbol=c if c != "*" else "*")
                i += 1
            idx = add_atom(atom)
            if prev is not None:
                add_bond(prev, idx, pending_bond, pending_dir)
                mol.atoms[idx].first_nbr_is_prev = True
            prev, pending_bond, pending_dir = idx, None, 0
        elif c in _BOND_CHARS:
            pending_bond = _BOND_CHARS[c]
            pending_dir = {"/": 1, "\\": -1}.get(c, 0)
            if pending_bond == 4 and c == "$":
                pending_bond = TRIPLE  # quadruple unsupported; approximate
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                num, i = int(smiles[i + 1:i + 3]), i + 3
            else:
                num, i = int(c), i + 1
            if prev is None:
                raise SmilesError("ring bond with no previous atom")
            if num in rings:
                a, order0, dir0, slot = rings.pop(num)
                order = pending_bond if pending_bond is not None else order0
                # a direction symbol at the CLOSING digit is oriented
                # closer -> opener; flip to the stored opener -> closer
                direction = dir0 if dir0 else -pending_dir
                if a == prev:
                    raise SmilesError("self ring bond")
                add_bond(a, prev, order, direction)
                # the ring bond occupies the opener's neighbor list at
                # the position of its OPENING digit, not at close time
                wl = mol.atoms[a].written_nbrs
                wl.pop()  # remove the append add_bond just did
                wl[slot] = prev
            else:
                mol.atoms[prev].written_nbrs.append(-2 - num)  # placeholder
                rings[num] = (prev, pending_bond, pending_dir,
                              len(mol.atoms[prev].written_nbrs) - 1)
            pending_bond, pending_dir = None, 0
        elif c == "(":
            stack.append((prev, pending_bond))
            pending_bond, pending_dir = None, 0
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unbalanced ')'")
            prev, _ = stack.pop()
            pending_bond, pending_dir = None, 0
            i += 1
        elif c == ".":
            prev, pending_bond, pending_dir = None, None, 0
            i += 1
        elif c in " \t":
            break
        else:
            raise SmilesError(f"unexpected char '{c}' at {i}")
    if rings:
        raise SmilesError(f"unclosed ring bonds: {sorted(rings)}")
    if stack:
        raise SmilesError("unbalanced '('")
    written_orders = [b.order for b in mol.bonds]
    written_aromatic = [a.aromatic for a in mol.atoms]
    _finalize(mol)
    if validate:
        _validate_valence(mol, written_orders)
        _validate_kekulizable(mol, written_orders, written_aromatic)
    return mol


# --------------------------------------------------------------------------
# Post-parse perception: rings, aromaticity, implicit Hs, hybridization.
# --------------------------------------------------------------------------

def _ring_bonds(mol: Mol, max_size: int = 8) -> List[List[int]]:
    """Return candidate simple rings (atom-index lists) of size 3..max_size.

    BFS spanning tree per component; each non-tree edge (v, w) closes the
    fundamental cycle v..lca(v,w)..w.  Fundamental cycles of a BFS tree are
    near-minimal, which covers the SSSR-style rings aromaticity perception
    needs (benzene, 5-rings, fused 6-6 systems).  Aromaticity perception
    passes max_size=12 so the azulene-class fused pass sees either member
    of a 5-7 pair even when BFS yields the 10-periphery instead."""
    n = mol.num_atoms()
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for bi, b in enumerate(mol.bonds):
        adj[b.a].append((b.b, bi))
        adj[b.b].append((b.a, bi))
    parent = [-1] * n
    depth = [-1] * n
    tree_bond = set()
    extra_bonds = []
    from collections import deque
    for root in range(n):
        if depth[root] >= 0:
            continue
        depth[root] = 0
        q = deque([root])
        while q:
            v = q.popleft()
            for (w, bi) in adj[v]:
                if depth[w] < 0:
                    depth[w] = depth[v] + 1
                    parent[w] = v
                    tree_bond.add(bi)
                    q.append(w)
                elif bi not in tree_bond:
                    extra_bonds.append(bi)
                    tree_bond.add(bi)  # record once
    rings: List[List[int]] = []
    seen = set()
    for bi in extra_bonds:
        v, w = mol.bonds[bi].a, mol.bonds[bi].b
        pv, pw = [v], [w]
        a, b = v, w
        while a != b:
            if depth[a] >= depth[b]:
                a = parent[a]
                pv.append(a)
            else:
                b = parent[b]
                pw.append(b)
        cycle = pv + pw[-2::-1]  # v..lca + (w..just-below-lca reversed)
        if 3 <= len(cycle) <= max_size:
            key = frozenset(cycle)
            if key not in seen:
                seen.add(key)
                rings.append(cycle)
    return rings


_PI_DONORS = {"N", "O", "S", "P"}  # can donate a lone pair to the pi system


def _perceive_aromaticity(mol: Mol) -> None:
    """Mark Kekulé-written aromatic rings (benzene-like) as aromatic.

    A ring qualifies when every member is sp2-capable and the Hückel
    electron count over the ring is 4n+2.  Conservative: handles benzene,
    pyridine, pyrrole, furan, thiophene, imidazole and fused 6-rings; it
    will not find every exotic aromatic system (neither does it need to —
    datasets overwhelmingly use aromatic-form SMILES)."""
    all_cycles = _ring_bonds(mol, max_size=12)
    rings = [r for r in all_cycles if len(r) <= 8]
    for r in rings:
        for a in r:
            mol.atoms[a].in_ring = True
    bond_idx = {}
    for bi, b in enumerate(mol.bonds):
        bond_idx[(b.a, b.b)] = bi
        bond_idx[(b.b, b.a)] = bi

    def ring_bond_ids(r: List[int]) -> List[int]:
        return [bond_idx[(r[k], r[(k + 1) % len(r)])] for k in range(len(r))]

    changed = True
    guard = 0
    while changed and guard < 4:
        changed = False
        guard += 1
        for r in rings:
            rb = ring_bond_ids(r)
            if all(mol.bonds[bi].order == AROMATIC for bi in rb):
                continue
            pi = 0
            ok = True
            for a in r:
                atom = mol.atoms[a]
                orders = [mol.bonds[bi].order for bi in atom.bonds]
                n_double = sum(1 for o in orders if o == DOUBLE)
                n_triple = sum(1 for o in orders if o == TRIPLE)
                n_arom = sum(1 for o in orders if o == AROMATIC)
                if n_triple or atom.symbol not in ("C", "N", "O", "S", "P", "B"):
                    ok = False
                    break
                # does this atom have a double bond inside the ring?
                has_ring_double = any(
                    mol.bonds[bi].order == DOUBLE and bi in rb
                    for bi in atom.bonds)
                exo_double = n_double > 0 and not has_ring_double
                if has_ring_double or n_arom:
                    pi += 1
                elif exo_double:
                    pi += 0  # e.g. quinone carbonyl C: sp2 but no ring pi e-
                elif atom.symbol in _PI_DONORS:
                    pi += 2  # lone pair donated (pyrrole N, furan O, ...)
                elif atom.symbol == "C" and atom.charge == -1:
                    pi += 2
                elif atom.symbol in ("C", "B") and atom.charge >= 0 and \
                        n_double == 0:
                    ok = False  # sp3 carbon in ring
                    break
            if ok and pi % 4 == 2:
                for bi in rb:
                    if mol.bonds[bi].order != AROMATIC:
                        mol.bonds[bi].order = AROMATIC
                        changed = True
                for a in r:
                    mol.atoms[a].aromatic = True
        # fused-system pass (azulene-class, RDKit parity): per-ring
        # Hückel misses systems whose 4n+2 count only holds over the
        # FUSED pair (azulene = 5+7 rings, 10 pi electrons; heptalene's
        # 12 and pentalene's 8 correctly fail).  Count pi over the atom
        # union of each bond-sharing ring pair; on 4n+2 with every
        # member sp2-capable, the whole system incl. the fusion bond
        # becomes aromatic.
        for i1 in range(len(all_cycles)):
            for i2 in range(i1 + 1, len(all_cycles)):
                r1, r2 = all_cycles[i1], all_cycles[i2]
                if len(set(r1) & set(r2)) < 2:
                    continue  # no shared bond: not a fused pair
                union = list(dict.fromkeys(r1 + r2))
                if len(union) > 10:
                    continue  # conservative: target the azulene class
                in_union = set(union)
                rb = set(ring_bond_ids(r1)) | set(ring_bond_ids(r2))
                if all(mol.bonds[bi].order == AROMATIC for bi in rb):
                    continue
                pi = 0
                ok = True
                for a in union:
                    atom = mol.atoms[a]
                    orders = [mol.bonds[bi].order for bi in atom.bonds]
                    n_double = sum(1 for o in orders if o == DOUBLE)
                    n_triple = sum(1 for o in orders if o == TRIPLE)
                    n_arom = sum(1 for o in orders if o == AROMATIC)
                    if n_triple or atom.symbol not in ("C", "N", "O",
                                                       "S", "P", "B"):
                        ok = False
                        break
                    has_sys_double = any(
                        mol.bonds[bi].order == DOUBLE
                        and mol.bonds[bi].other(a) in in_union
                        for bi in atom.bonds)
                    exo_double = n_double > 0 and not has_sys_double
                    if has_sys_double or n_arom:
                        pi += 1
                    elif exo_double:
                        pi += 0  # carbonyl-style sp2: no system pi e-
                    elif atom.symbol in _PI_DONORS:
                        pi += 2
                    elif atom.symbol == "C" and atom.charge == -1:
                        pi += 2
                    elif atom.symbol in ("C", "B") and atom.charge >= 0 \
                            and n_double == 0:
                        ok = False  # sp3 carbon in the system
                        break
                if ok and pi % 4 == 2:
                    for bi in rb:
                        if mol.bonds[bi].order != AROMATIC:
                            mol.bonds[bi].order = AROMATIC
                            changed = True
                    for a in union:
                        mol.atoms[a].aromatic = True


def _implicit_h(atom: Atom, bond_order_sum: float) -> int:
    if atom.in_bracket:
        return atom.explicit_h or 0
    vals = _VALENCES.get(atom.symbol)
    if vals is None:
        return 0
    need = int(-(-bond_order_sum // 1))  # ceil
    for v in vals:
        if v >= need:
            return v - need
    return 0


def _hybridization(mol: Mol, i: int) -> int:
    atom = mol.atoms[i]
    if atom.aromatic:
        return SP2
    orders = [mol.bonds[bi].order for bi in atom.bonds]
    n_double = sum(1 for o in orders if o == DOUBLE)
    n_triple = sum(1 for o in orders if o == TRIPLE)
    if n_triple or n_double >= 2:
        return SP
    ve = _VALENCE_ELECTRONS.get(atom.symbol)
    if ve is None:
        return OTHER_HYB
    sigma = len(orders) + atom.num_h
    bond_e = sum(_BOND_ORDER[o] for o in orders) + atom.num_h
    lone_pairs = max(0, int((ve - atom.charge - bond_e) // 2))
    steric = sigma + lone_pairs
    if n_double == 1:
        return SP2
    if steric >= 4:
        return SP3
    if steric == 3:
        return SP2
    if steric == 2:
        return SP
    return OTHER_HYB


def _finalize(mol: Mol) -> None:
    # Implicit-H counts must be spelling-invariant: Kekulé and aromatic
    # forms of one molecule feed the same canonical molecule key
    # (chem/scaffold.py molecule_key — the DDI store dedup, reference
    # src_2gi_ddi/dataset.py:118-124 canonical SMILES).  Snapshot the
    # as-written bond orders before aromaticity perception rewrites
    # ring bonds to order 4, and remember which atoms the INPUT spelled
    # aromatic (lowercase) vs. which perception upgraded.
    written_orders = [b.order for b in mol.bonds]
    written_aromatic = [a.aromatic for a in mol.atoms]
    _perceive_aromaticity(mol)
    for i, atom in enumerate(mol.atoms):
        if atom.aromatic and not atom.in_bracket \
                and atom.symbol in ("O", "S", "Se", "Te") \
                and len(atom.bonds) == 2:
            # two-connected aromatic chalcogens donate a lone pair
            # (furan O / thiophene S / selenophene Se): no implicit H
            # in either spelling (RDKit semantics)
            atom.num_h = 0
            continue
        if written_aromatic[i]:
            s = sum(_BOND_ORDER[mol.bonds[bi].order] for bi in atom.bonds)
        else:
            # Kekulé-written atom: the input's bond orders define the
            # valence — the aromatic rewrite must not change H counts
            # (C1=CC=CN1 is pyrrole with an N-H, same as c1cc[nH]c1)
            s = sum(_BOND_ORDER[written_orders[bi]] for bi in atom.bonds)
        atom.num_h = _implicit_h(atom, s)
    for i, atom in enumerate(mol.atoms):
        atom.hybridization = _hybridization(mol, i)
