"""Sanitization and fragment helpers: valence validity per element
(ALLOWED_BONDS), lazy aromaticity perception, largest-fragment extraction
and the connectivity fraction."""

from __future__ import annotations

from diffndm_tpu_torch.chem.mol import Molecule


class SanitizeError(ValueError):
    pass


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
