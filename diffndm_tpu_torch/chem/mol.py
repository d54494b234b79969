"""Minimal heavy-atom molecular graph: element symbols, bonds with their
orders and coordinates, and the graph queries molecule building and SDF
output need."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Molecule:
    """symbols: heavy-atom element symbols; bonds: (i, j, order) with order
    in {1, 2, 3}; coords: optional [N, 3] Angstroms."""

    symbols: List[str]
    bonds: List[Tuple[int, int, int]]
    coords: Optional[np.ndarray] = None
    _cache: dict = field(default_factory=dict, repr=False)

    @property
    def n_atoms(self) -> int:
        return len(self.symbols)

    def _cached(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    @property
    def neighbors(self) -> List[List[int]]:
        def build():
            nb = [[] for _ in range(self.n_atoms)]
            for i, j, _ in self.bonds:
                nb[i].append(j)
                nb[j].append(i)
            return nb
        return self._cached("neighbors", build)

    def fragments(self) -> List[List[int]]:
        """Connected components (sorted atom index lists)."""
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
