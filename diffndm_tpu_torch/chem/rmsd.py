"""Symmetry-corrected RMSD between conformers of the same molecule.

Docking evaluations that compare a pose to the crystal ligand by raw
atom-index RMSD over-penalise chemically equivalent poses (a flipped
benzene, swapped carboxylate oxygens, rotated t-butyl).  The standard
metric (what DockRMSD / spyrmsd / obrms compute, and what the
reference's qvina2-based evaluations implicitly rely on through
obfit-style tooling) minimises RMSD over the molecular graph's
automorphism group.  This module enumerates automorphisms directly on
the in-package Molecule graph (atoms coloured by element+charge, edges
by bond order) with a backtracking search — ligand graphs are tiny, and
the count is capped defensively.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from diffndm_tpu_torch.chem.mol import Molecule


def _colors(mol: Molecule) -> List[tuple]:
    """Initial vertex colours: element, charge, degree, and the sorted
    multiset of (neighbour element, bond order) — a 1-WL step that
    prunes most of the backtracking space."""
    nbr = [[] for _ in range(mol.n_atoms)]
    for i, j, o in mol.bonds:
        nbr[i].append((mol.symbols[j], o))
        nbr[j].append((mol.symbols[i], o))
    return [(mol.symbols[i], mol.charge(i), len(nbr[i]),
             tuple(sorted(nbr[i]))) for i in range(mol.n_atoms)]


def graph_automorphisms(mol: Molecule, max_count: int = 2000
                        ) -> Iterator[np.ndarray]:
    """Yield automorphism permutations p (so atom i maps to p[i]),
    identity first; stops after max_count (safety for pathological
    graphs — real ligands have small groups)."""
    n = mol.n_atoms
    colors = _colors(mol)
    adj = {}
    for i, j, o in mol.bonds:
        adj[(i, j)] = o
        adj[(j, i)] = o
    order = sorted(range(n), key=lambda i: colors.count(colors[i]))
    perm = np.full(n, -1, np.int64)
    used = np.zeros(n, bool)
    yielded = 0

    def backtrack(k: int):
        nonlocal yielded
        if yielded >= max_count:
            return
        if k == n:
            yielded += 1
            yield perm.copy()
            return
        i = order[k]
        for c in range(n):
            if used[c] or colors[c] != colors[i]:
                continue
            ok = True
            for k2 in range(k):
                j = order[k2]
                if adj.get((i, j)) != adj.get((c, perm[j])):
                    ok = False
                    break
            if not ok:
                continue
            perm[i] = c
            used[c] = True
            yield from backtrack(k + 1)
            used[c] = False
            perm[i] = -1

    yield from backtrack(0)


def symmetry_rmsd(mol: Molecule, x: np.ndarray, y: np.ndarray,
                  max_autos: int = 2000) -> float:
    """min over graph automorphisms p of RMSD(x[p], y) — the
    symmetry-corrected heavy-atom RMSD between two conformers of `mol`
    (no alignment: poses are compared in the receptor frame, the
    docking convention)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    best = float("inf")
    for p in graph_automorphisms(mol, max_count=max_autos):
        r = float(np.sqrt(((x[p] - y) ** 2).sum(-1).mean()))
        if r < best:
            best = r
    if not np.isfinite(best):  # no automorphism found (shouldn't happen)
        best = float(np.sqrt(((x - y) ** 2).sum(-1).mean()))
    return best
