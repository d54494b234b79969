"""Minimal heavy-atom molecular graph with the chemistry the drug-likeness
metrics need: implicit hydrogens, valences, ring perception, aromaticity,
fragments.

Heavy atoms only; H is implicit and inferred from default valences, which
is how generated point clouds (no explicit H) are interpreted.  The same
rules as the JAX package's ``chem/mol.py``, so that every property
computed on a Molecule agrees with it bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from diffndm_tpu_torch.constants import ALLOWED_BONDS, MONOISOTOPIC_MASS

# Elements for which we add implicit hydrogens (organic subset).
_ORGANIC_DEFAULT_VALENCE = {
    "B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
    "F": 1, "Cl": 1, "Br": 1, "I": 1, "H": 1,
}
# second allowed valence states (hypervalent)
_EXTRA_VALENCE = {"P": 5, "S": 6, "N": 3}
# full hypervalent ladders (RDKit default valence lists) used to derive
# implicit H for neutral atoms whose explicit valence exceeds the default
_VALENCE_LADDERS = {"P": (3, 5), "S": (2, 4, 6)}


@dataclass
class Molecule:
    """symbols: heavy-atom element symbols; bonds: (i, j, order) with order
    in {1, 2, 3}; coords: optional [N, 3] Angstroms."""

    symbols: List[str]
    bonds: List[Tuple[int, int, int]]
    coords: Optional[np.ndarray] = None
    # formal charges per atom (None = all neutral); only SMILES-derived
    # molecules carry charges, generated point clouds are neutral
    charges: Optional[List[int]] = None
    _cache: dict = field(default_factory=dict, repr=False)

    def charge(self, i: int) -> int:
        return 0 if self.charges is None else int(self.charges[i])

    # -- basic graph -------------------------------------------------------
    @property
    def n_atoms(self) -> int:
        return len(self.symbols)

    def _cached(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def adjacency(self) -> np.ndarray:
        def build():
            a = np.zeros((self.n_atoms, self.n_atoms), dtype=np.int8)
            for i, j, o in self.bonds:
                a[i, j] = a[j, i] = o
            return a
        return self._cached("adjacency", build)

    @property
    def neighbors(self) -> List[List[int]]:
        def build():
            nb = [[] for _ in range(self.n_atoms)]
            for i, j, _ in self.bonds:
                nb[i].append(j)
                nb[j].append(i)
            return nb
        return self._cached("neighbors", build)

    def degree(self, i: int) -> int:
        return len(self.neighbors[i])

    @property
    def _bond_order_sums(self) -> np.ndarray:
        # cached per-atom explicit bond-order sums: the descriptors call
        # bond_order_sum/implicit_h per atom many times per molecule and
        # a fresh numpy row-sum per call dominated the oracle profile
        return self._cached("bond_order_sums",
                            lambda: self.adjacency.sum(axis=1))

    def bond_order_sum(self, i: int) -> int:
        """Sum of explicit bond orders at atom i (aromatic handled as the
        kekulized orders stored in self.bonds)."""
        return int(self._bond_order_sums[i])

    # -- implicit hydrogens / valence -------------------------------------
    def implicit_h(self, i: int) -> int:
        hs = self._cached(
            "implicit_hs",
            lambda: [self._implicit_h_uncached(j)
                     for j in range(self.n_atoms)])
        return hs[i]

    def _implicit_h_uncached(self, i: int) -> int:
        sym = self.symbols[i]
        dv = _ORGANIC_DEFAULT_VALENCE.get(sym)
        if dv is None:
            return 0
        q = self.charge(i)
        if q:
            # standard formal-charge valence adjustment: +1 raises the
            # default valence for N/P/O/S ([NH4+], [OH3+]), -1 lowers it
            # ([O-], [S-]); carbanions/boranides lose a slot either way
            if sym in ("N", "P", "O", "S"):
                dv = dv + q
            else:
                dv = dv - abs(q)
        bos = self.bond_order_sum(i)
        if bos > dv and q == 0:
            # hypervalent neutral atoms climb the valence ladder like RDKit
            # (P: 3->5, S: 2->4->6); explicit valence beyond the largest
            # allowed state leaves no room for implicit H
            for v in _VALENCE_LADDERS.get(sym, ()):
                if bos <= v:
                    dv = v
                    break
        return max(0, dv - bos)

    def total_h(self, i: int) -> int:
        return self.implicit_h(i) + sum(
            1 for j in self.neighbors[i] if self.symbols[j] == "H")

    def valence_ok(self, i: int) -> bool:
        """Atom obeys one of its allowed valences (with implicit H filling
        up to the default); formal charges shift the budget the same way
        implicit_h accounts for them (e.g. [N+] carries 4 bonds)."""
        sym = self.symbols[i]
        allowed = ALLOWED_BONDS.get(sym)
        if allowed is None:
            return False
        q = self.charge(i)
        shift = 0
        if q:
            shift = q if sym in ("N", "P", "O", "S") else -abs(q)
        v = self.bond_order_sum(i) - shift
        if isinstance(allowed, tuple):
            return v <= max(allowed)
        return v <= allowed or v <= _EXTRA_VALENCE.get(sym, 0)

    # -- rings -------------------------------------------------------------
    @property
    def rings(self) -> List[List[int]]:
        """Smallest set of smallest rings (fast BFS SSSR, chem.rings)."""
        def build():
            from diffndm_tpu_torch.chem.rings import find_rings

            return find_rings(self.n_atoms,
                              [(i, j) for i, j, _ in self.bonds])
        return self._cached("rings", build)

    @property
    def ring_membership(self) -> np.ndarray:
        def build():
            m = np.zeros(self.n_atoms, dtype=bool)
            for r in self.rings:
                m[list(r)] = True
            return m
        return self._cached("ring_membership", build)

    def in_ring_bond(self, i: int, j: int) -> bool:
        for r in self.rings:
            rs = set(r)
            if i in rs and j in rs:
                # both endpoints on the same cycle: check they are adjacent
                # on that cycle (cycle basis gives unordered node sets; for
                # bonds we accept membership of both)
                return True
        return False

    # -- aromaticity -------------------------------------------------------
    @property
    def aromatic_rings(self) -> List[List[int]]:
        """Rings classed aromatic by a simplified Hückel test: every ring
        atom sp2-capable and pi-electron count = 4n+2."""
        def build():
            out = []
            for ring in self.rings:
                if len(ring) < 5 or len(ring) > 7:
                    continue
                pi = 0
                ok = True
                for a in ring:
                    c = self._pi_electrons(a, set(ring))
                    if c is None:
                        ok = False
                        break
                    pi += c
                if ok and pi % 4 == 2:
                    out.append(ring)
            return out
        return self._cached("aromatic_rings", build)

    def _pi_electrons(self, a: int, ring: set) -> Optional[int]:
        """pi electrons atom `a` contributes to an aromatic system, or None
        if it cannot be part of one."""
        sym = self.symbols[a]
        orders = [int(self.adjacency[a, j]) for j in self.neighbors[a]]
        has_double = any(o == 2 for o in orders)
        if any(o == 3 for o in orders):
            return None
        deg_h = self.degree(a) + self.implicit_h(a)
        if sym == "C":
            if has_double:
                return 1
            return None  # sp3 carbon breaks aromaticity
        if sym in ("N", "P"):
            if has_double:
                return 1  # pyridine-like
            if deg_h <= 3:
                return 2  # pyrrole-like lone pair
            return None
        if sym in ("O", "S"):
            if has_double:
                return 1
            return 2  # furan/thiophene-like
        return None

    @property
    def aromatic_atoms(self) -> np.ndarray:
        def build():
            m = np.zeros(self.n_atoms, dtype=bool)
            for r in self.aromatic_rings:
                m[list(r)] = True
            return m
        return self._cached("aromatic_atoms", build)

    def is_aromatic_atom(self, i: int) -> bool:
        return bool(self.aromatic_atoms[i])

    # -- fragments ---------------------------------------------------------
    def fragments(self) -> List[List[int]]:
        """Connected components (atom index lists)."""
        def build():
            seen = np.zeros(self.n_atoms, dtype=bool)
            comps = []
            for s in range(self.n_atoms):
                if seen[s]:
                    continue
                stack, comp = [s], []
                seen[s] = True
                while stack:
                    u = stack.pop()
                    comp.append(u)
                    for v in self.neighbors[u]:
                        if not seen[v]:
                            seen[v] = True
                            stack.append(v)
                comps.append(sorted(comp))
            return comps
        return self._cached("fragments", build)

    def subgraph(self, atoms: Sequence[int]) -> "Molecule":
        atoms = list(atoms)
        remap = {a: i for i, a in enumerate(atoms)}
        bonds = [(remap[i], remap[j], o) for i, j, o in self.bonds
                 if i in remap and j in remap]
        coords = None if self.coords is None else self.coords[atoms]
        return Molecule([self.symbols[a] for a in atoms], bonds, coords)

    # -- misc --------------------------------------------------------------
    @property
    def mol_weight(self) -> float:
        """Monoisotopic molecular weight including implicit H (matches
        rdkit Descriptors.ExactMolWt on the implicit-H interpretation)."""
        w = sum(MONOISOTOPIC_MASS.get(s, 0.0) for s in self.symbols)
        w += MONOISOTOPIC_MASS["H"] * sum(
            self.implicit_h(i) for i in range(self.n_atoms))
        return w

    def canonical_smiles_like(self) -> str:
        """The identity key of uniqueness and novelty: not SMILES syntax
        but a Weisfeiler-Lehman canonical hash of the heavy-atom graph
        (``fingerprints.wl_canonical_key``), equal for isomorphic graphs."""
        from diffndm_tpu_torch.chem.fingerprints import wl_canonical_key

        return wl_canonical_key(self)
