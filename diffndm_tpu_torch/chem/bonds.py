"""Bond perception from 3D coordinates (numpy host code).

Connectivity by OpenBabel's ConnectTheDots rule (bond when the distance
is below rcov_i + rcov_j + 0.45 A and above 0.4 A; over-coordinated atoms
drop their longest bonds), kekulization of aromatic rings by a
deterministic maximum matching, then greedy valence-checked upgrades to
double and triple bonds, closest pairs first.
"""

from __future__ import annotations

from typing import List

import numpy as np

from diffndm_tpu_torch.chem.matching import max_matching
from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.chem.rings import find_rings
from diffndm_tpu_torch.constants import (ALLOWED_BONDS, MARGIN2, MARGIN3,
                                         OB_COVALENT_RADII, OB_MAX_BONDS)


def _max_valence(sym: str) -> int:
    v = ALLOWED_BONDS.get(sym, 0)
    return max(v) if isinstance(v, tuple) else v


def build_molecule(coords: np.ndarray, type_idx: np.ndarray,
                   dataset_info: dict) -> Molecule:
    """Point cloud (Angstroms, atom type indices) -> Molecule."""
    n = len(coords)
    decoder = dataset_info["atom_decoder"]
    symbols = [decoder[int(i)] for i in type_idx]
    coords = np.asarray(coords, np.float64)
    if n == 0:
        return Molecule([], [], coords=coords)

    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1) * 100
    t = np.asarray(type_idx)
    b1p = np.asarray(dataset_info["bonds1"])[t[:, None], t[None, :]]
    b2p = np.asarray(dataset_info["bonds2"])[t[:, None], t[None, :]]
    b3p = np.asarray(dataset_info["bonds3"])[t[:, None], t[None, :]]

    # 1) connectivity; over-coordinated atoms (smallest index first) drop
    # their longest bond (first maximum on ties)
    rcov = np.array([OB_COVALENT_RADII.get(s, 77.0) for s in symbols])
    conn = (d < rcov[:, None] + rcov[None, :] + 45.0) & (d > 40.0)
    np.fill_diagonal(conn, False)
    obcap = np.array([OB_MAX_BONDS.get(s, 4) for s in symbols])
    deg = conn.sum(1)
    while True:
        overs = np.nonzero(deg > obcap)[0]
        if len(overs) == 0:
            break
        a = int(overs[0])
        nb = np.nonzero(conn[a])[0]
        j = int(nb[np.argmax(d[a, nb])])
        conn[a, j] = conn[j, a] = False
        deg[a] -= 1
        deg[j] -= 1
    iu = np.triu_indices(n, k=1)
    edges = [(int(i), int(j)) for i, j in zip(*iu) if conn[i, j]]
    order = {e: 1 for e in edges}
    used = np.zeros(n)  # bond-order sum per atom
    for i, j in edges:
        used[i] += 1
        used[j] += 1
    cap = np.array([_max_valence(s) for s in symbols], dtype=float)

    # 2) aromatic rings: 5-7 C/N/O/S atoms of degree <= 3 whose bonds sit
    # below midway between the single- and double-bond lengths (+ slack)
    arom_edges = set()
    arom_atoms = set()
    for ring in find_rings(n, edges):
        if not (5 <= len(ring) <= 7):
            continue
        rs = set(ring)
        ring_edges = [(i, j) for (i, j) in edges if i in rs and j in rs]
        if len(ring_edges) != len(ring):
            continue  # fused/bridged handled ring-by-ring
        if any(symbols[a] not in ("C", "N", "O", "S") or deg[a] > 3
               for a in ring):
            continue
        n_arom = sum(1 for (i, j) in ring_edges
                     if b2p[i, j] > 0
                     and d[i, j] < (b1p[i, j] + b2p[i, j]) / 2 + 6)
        if n_arom >= len(ring) - 1:
            arom_edges.update(ring_edges)
            arom_atoms.update(ring)

    if arom_edges:
        # one pi bond for every C and every pyridine-like N (degree 2);
        # O and S give lone pairs and stay unmatched
        need = {a for a in arom_atoms
                if symbols[a] == "C" or (symbols[a] == "N" and deg[a] == 2)}
        mm_edges = sorted((i, j) for (i, j) in arom_edges
                          if i in need and j in need)
        nodes = sorted(need)
        remap = {a: k for k, a in enumerate(nodes)}
        match = max_matching(len(nodes),
                             [(remap[i], remap[j]) for i, j in mm_edges])
        for k, m in enumerate(match):
            if m > k:
                i, j = nodes[k], nodes[m]
                order[(i, j)] = 2
                used[i] += 1
                used[j] += 1

    # 3) greedy valence-checked upgrades outside aromatic rings
    cands = []
    for (i, j) in edges:
        if (i, j) in arom_edges:
            continue
        if b3p[i, j] > 0 and d[i, j] < b3p[i, j] + MARGIN3:
            cands.append((d[i, j] - b3p[i, j], 2, (i, j)))  # +2 -> triple
        elif b2p[i, j] > 0 and d[i, j] < b2p[i, j] + MARGIN2:
            cands.append((d[i, j] - b2p[i, j], 1, (i, j)))  # +1 -> double
    cands.sort()
    for _, inc, (i, j) in cands:
        if used[i] + inc <= cap[i] and used[j] + inc <= cap[j]:
            order[(i, j)] += inc
            used[i] += inc
            used[j] += inc

    bonds = [(i, j, order[(i, j)]) for (i, j) in edges]
    return Molecule(symbols, bonds, coords=coords)


def build_molecules_batch(coords: np.ndarray, types: np.ndarray,
                          mask: np.ndarray, dataset_info: dict
                          ) -> List[Molecule]:
    """Padded batch [B, N, ...] -> one Molecule per row (mask-selected)."""
    out = []
    for b in range(coords.shape[0]):
        m = mask[b] > 0.5
        out.append(build_molecule(coords[b][m], types[b][m], dataset_info))
    return out
