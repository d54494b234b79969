"""SMILES strings to kekulized heavy-atom ``Molecule`` graphs.

SMILES enter twice: the Binding MOAD drug-likeness filter scores each
label-file ligand from its SMILES, and novelty compares against the
training set's molecules.  The parser covers the part of the Daylight
grammar those strings use:

- organic-subset atoms (B C N O P S F Cl Br I) and aromatic b c n o p s;
- bracket atoms with isotope (ignored), symbol, aromaticity, chirality
  (ignored), explicit H count and formal charge; an explicit [H] atom is
  folded into its neighbour;
- bonds ``- = # :`` (``/ \\`` read as single: no geometry is kept),
  branches, ring closures including ``%nn``, and dot-separated
  components kept as disconnected fragments;
- kekulization of aromatic systems by a backtracking perfect matching
  over the atoms that need a double bond (pyridine-type n against
  pyrrole-type [nH] or substituted n; neutral o and s give lone pairs;
  charged atoms through the valence rule of ``Molecule.implicit_h``),
  searched in atom and bond order, as the JAX package's ``chem/smiles.py``
  does, so that ties resolve to the same double bonds;
- pentavalent nitro N(=O)=O rewritten as [N+](=O)[O-].

Bracket H counts are read but not stored: hydrogens are derived from
valence, as for molecules built from coordinates.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from diffndm_tpu_torch.chem.mol import Molecule

_TWO_LETTER = ("Cl", "Br")
_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, "/": 1, "\\": 1}

_BRACKET = re.compile(
    r"^(?P<isotope>\d+)?(?P<symbol>[A-Za-z][a-z]?)(?P<chiral>@{1,2})?"
    r"(?P<hcount>H\d*)?(?P<charge>(\+{1,3}|-{1,3}|\+\d+|-\d+))?"
    r"(?::\d+)?$")


class SmilesError(ValueError):
    pass


def parse_smiles(s: str) -> Molecule:
    """Parse a SMILES string into a kekulized Molecule (no coordinates)."""
    s = s.strip()
    if not s:
        raise SmilesError("empty SMILES")
    symbols: List[str] = []
    aromatic: List[bool] = []
    charges: List[int] = []
    hcounts: List[Optional[int]] = []
    bonds: List[List[int]] = []  # [i, j, order]; 0 = aromatic placeholder

    prev: Optional[int] = None
    pending: Optional[str] = None
    stack: List[Optional[int]] = []
    ring_open: Dict[str, Tuple[int, Optional[str]]] = {}

    def add_atom(sym: str, arom: bool, charge: int = 0,
                 hcount: Optional[int] = None) -> int:
        symbols.append(sym)
        aromatic.append(arom)
        charges.append(charge)
        hcounts.append(hcount)
        return len(symbols) - 1

    def add_bond(i: int, j: int, bond_sym: Optional[str]) -> None:
        if bond_sym == ".":
            return
        if bond_sym is None:
            order = 0 if (aromatic[i] and aromatic[j]) else 1
        elif bond_sym == ":":
            order = 0
        else:
            order = _BOND_ORDER[bond_sym]
        bonds.append([i, j, order])

    def connect(idx: int) -> None:
        nonlocal prev, pending
        if prev is not None and pending != ".":
            add_bond(prev, idx, pending)
        prev = idx
        pending = None

    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {s!r}")
            prev = stack.pop()
            i += 1
        elif c in "-=#:/\\.":
            pending = c
            i += 1
        elif c == "%" or c.isdigit():
            if c == "%":
                num = s[i + 1:i + 3]
                if len(num) != 2 or not num.isdigit():
                    raise SmilesError(f"bad %ring closure in {s!r}")
                i += 3
            else:
                num = c
                i += 1
            if prev is None:
                raise SmilesError(f"ring closure before any atom in {s!r}")
            if num in ring_open:
                j, open_sym = ring_open.pop(num)
                add_bond(prev, j, pending if pending is not None
                         else open_sym)
            else:
                ring_open[num] = (prev, pending)
            pending = None
        elif c == "[":
            end = s.find("]", i)
            if end < 0:
                raise SmilesError(f"unterminated bracket atom in {s!r}")
            m = _BRACKET.match(s[i + 1:end])
            if not m:
                raise SmilesError(f"bad bracket atom {s[i:end + 1]!r}")
            raw = m.group("symbol")
            arom = raw[0].islower()
            sym = raw.capitalize() if arom else raw
            if sym == "H":
                # explicit hydrogen atom node: attach as +1 H count on the
                # previous atom (heavy-atom-only representation)
                if prev is None:
                    raise SmilesError(f"lone [H] in {s!r}")
                i = end + 1
                pending = None
                continue
            hc = m.group("hcount")
            hcount = (1 if hc == "H" else int(hc[1:])) if hc else None
            ch = m.group("charge") or ""
            if ch in ("+", "++", "+++"):
                charge = len(ch)
            elif ch in ("-", "--", "---"):
                charge = -len(ch)
            elif ch:
                charge = int(ch)
            else:
                charge = 0
            connect(add_atom(sym, arom, charge, hcount))
            i = end + 1
        else:
            two = s[i:i + 2]
            if two in _TWO_LETTER:
                connect(add_atom(two, False))
                i += 2
            elif c.upper() in _ORGANIC and c.isupper():
                connect(add_atom(c, False))
                i += 1
            elif c in _AROMATIC_ORGANIC:
                connect(add_atom(c.upper(), True))
                i += 1
            else:
                raise SmilesError(f"unexpected character {c!r} in {s!r}")
    if ring_open:
        raise SmilesError(f"unclosed ring bonds {list(ring_open)} in {s!r}")
    if stack:
        raise SmilesError(f"unbalanced '(' in {s!r}")

    _kekulize(symbols, aromatic, charges, hcounts, bonds, s)
    _normalize_hypervalent_nitro(symbols, charges, bonds)
    mol = Molecule(symbols=symbols,
                   bonds=[(i_, j_, o) for i_, j_, o in bonds],
                   coords=None,
                   charges=charges if any(charges) else None)
    return mol


def _normalize_hypervalent_nitro(symbols, charges, bonds) -> None:
    """Legacy nitro SMILES write pentavalent N(=O)=O; normalize to the
    charge-separated [N+](=O)[O-] form (what RDKit does on sanitize)."""
    for a, sym in enumerate(symbols):
        if sym != "N" or charges[a]:
            continue
        dbl_o = [k for k, (i, j, o) in enumerate(bonds)
                 if o == 2 and ((i == a and symbols[j] == "O")
                                or (j == a and symbols[i] == "O"))]
        order_sum = sum(o for i, j, o in bonds if a in (i, j))
        if len(dbl_o) >= 2 and order_sum > 4:
            k = dbl_o[0]
            bonds[k][2] = 1
            o_idx = bonds[k][1] if bonds[k][0] == a else bonds[k][0]
            charges[a] = 1
            charges[o_idx] = -1


def _kekulize(symbols, aromatic, charges, hcounts, bonds, src) -> None:
    """Assign alternating double bonds to aromatic systems in place."""
    arom_bonds = [k for k, (i, j, o) in enumerate(bonds) if o == 0]
    if not arom_bonds:
        return

    deg = [0] * len(symbols)
    has_exo_double = [False] * len(symbols)
    for i, j, o in bonds:
        deg[i] += 1
        deg[j] += 1
        if o == 2:
            has_exo_double[i] = has_exo_double[j] = True

    def needs_double(a: int) -> bool:
        sym, q = symbols[a], charges[a]
        h = hcounts[a] or 0
        if has_exo_double[a]:
            return False
        if sym == "C":
            return q == 0
        if sym in ("N", "P"):
            # pyridine-type (2 connections, no H) needs one; pyrrole-type
            # ([nH] or 3-substituted) contributes its lone pair; a positive
            # charge opens one more bonding slot (pyridinium)
            return deg[a] + h <= 2 + max(q, 0)
        if sym in ("O", "S"):
            return q > 0
        return False

    need = [a for a in range(len(symbols)) if aromatic[a]
            and needs_double(a)]
    need_set = set(need)
    adj: Dict[int, List[Tuple[int, int]]] = {a: [] for a in need}
    for k in arom_bonds:
        i, j, _ = bonds[k]
        if i in need_set and j in need_set:
            adj[i].append((j, k))
            adj[j].append((i, k))

    matched: Dict[int, int] = {}  # atom -> bond index

    def backtrack(order_pos: int) -> bool:
        while order_pos < len(need) and need[order_pos] in matched:
            order_pos += 1
        if order_pos == len(need):
            return True
        a = need[order_pos]
        for b, k in adj[a]:
            if b not in matched:
                matched[a] = k
                matched[b] = k
                if backtrack(order_pos + 1):
                    return True
                del matched[a]
                del matched[b]
        return False

    if not backtrack(0):
        raise SmilesError(f"cannot kekulize aromatic system in {src!r}")
    double_bonds = set(matched.values())
    for k in arom_bonds:
        bonds[k][2] = 2 if k in double_bonds else 1
