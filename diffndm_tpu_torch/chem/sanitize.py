"""Sanitization, fragment helpers and the output filter pipeline:
valence validity per element (ALLOWED_BONDS), lazy aromaticity
perception, largest-fragment extraction, the connectivity fraction, the
fused 3-ring filter and a geometry clean-up.

``relax`` is not a force field: harmonic bond terms that hold the current
bond lengths plus a soft repulsion between non-bonded atoms closer than
1.7 A, by float64 steepest descent, the same arithmetic as the JAX
package's copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from diffndm_tpu_torch.chem.mol import Molecule


class SanitizeError(ValueError):
    pass


def check_valences(mol: Molecule) -> bool:
    return all(mol.valence_ok(i) for i in range(mol.n_atoms))


def sanitize(mol: Molecule) -> Molecule:
    """Validity check in the spirit of Chem.SanitizeMol: every atom must
    satisfy an allowed valence; triggers ring/aromatic perception."""
    for i in range(mol.n_atoms):
        if not mol.valence_ok(i):
            raise SanitizeError(
                f"atom {i} ({mol.symbols[i]}) has bond order sum "
                f"{mol.bond_order_sum(i)}")
    _ = mol.aromatic_rings  # perceive aromaticity
    return mol


def is_valid(mol: Molecule) -> bool:
    try:
        sanitize(mol)
        return True
    except SanitizeError:
        return False


def largest_fragment(mol: Molecule) -> Molecule:
    return mol.subgraph(max(mol.fragments(), key=len))


def connectivity_fraction(mol: Molecule) -> float:
    """Fraction of atoms in the largest connected fragment."""
    if mol.n_atoms == 0:
        return 0.0
    return max(len(f) for f in mol.fragments()) / mol.n_atoms


def filter_ring33(mol: Molecule) -> bool:
    """False if two 3-rings share an atom."""
    rings = [set(r) for r in mol.rings]
    for i, ra in enumerate(rings):
        if len(ra) != 3:
            continue
        for j, rb in enumerate(rings):
            if i <= j or len(rb) != 3:
                continue
            if ra & rb:
                return False
    return True


def relax(mol: Molecule, max_iter: int = 200, lr: float = 1e-3) -> Molecule:
    """``max_iter`` steepest-descent steps of size ``lr`` on the bonded
    harmonic terms (toward the starting bond lengths) and the non-bonded
    repulsion below 1.7 A."""
    if mol.coords is None or mol.n_atoms < 2:
        return mol
    x = mol.coords.copy()
    bonded = mol.adjacency > 0
    d0 = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    target = np.where(bonded, d0, 0.0)
    for _ in range(max_iter):
        diff = x[:, None] - x[None, :]
        dist = np.linalg.norm(diff, axis=-1) + 1e-9
        np.fill_diagonal(dist, np.inf)
        unit = diff / dist[..., None]
        f = np.zeros_like(x)
        stretch = np.where(bonded, dist - target, 0.0)
        f -= (stretch[..., None] * unit).sum(axis=1)
        rep = np.where(~bonded & (dist < 1.7), (1.7 - dist), 0.0)
        f += (rep[..., None] * unit).sum(axis=1)
        x = x + lr * f
    return Molecule(list(mol.symbols), list(mol.bonds), coords=x)


def process_molecule(mol: Molecule, sanitize_flag: bool = False,
                     relax_iter: int = 0, largest_frag: bool = False
                     ) -> Optional[Molecule]:
    """The output filter: sanitize, keep the largest fragment, relax, in
    that order, sanitizing again after each change when asked.  Returns
    None for a molecule that fails."""
    if sanitize_flag and not is_valid(mol):
        return None
    if largest_frag:
        mol = largest_fragment(mol)
        if sanitize_flag and not is_valid(mol):
            return None
    if relax_iter > 0:
        mol = relax(mol, max_iter=relax_iter)
        if sanitize_flag and not is_valid(mol):
            return None
    return mol
