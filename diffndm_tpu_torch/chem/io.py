"""Molecule output as SDF (V2000)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from diffndm_tpu_torch.chem.mol import Molecule


def mol_to_sdf_block(mol: Molecule, name: str = "") -> str:
    n_atoms = mol.n_atoms
    lines = [name, "  DiffNDM-TPU", ""]
    lines.append(f"{n_atoms:>3}{len(mol.bonds):>3}  0  0  0  0  0  0  0  0999 "
                 "V2000")
    coords = (mol.coords if mol.coords is not None
              else np.zeros((n_atoms, 3)))
    for i in range(n_atoms):
        x, y, z = coords[i]
        lines.append(f"{x:>10.4f}{y:>10.4f}{z:>10.4f} "
                     f"{mol.symbols[i]:<3} 0  0  0  0  0  0  0  0  0  0  0  0")
    for i, j, o in mol.bonds:
        lines.append(f"{i + 1:>3}{j + 1:>3}{min(o, 3):>3}  0  0  0  0")
    lines.append("M  END")
    lines.append("$$$$")
    return "\n".join(lines) + "\n"


def write_sdf(path: str, mols: Sequence[Optional[Molecule]]) -> None:
    """One SDF record per molecule, named mol_<index>; None is skipped."""
    with open(path, "w") as f:
        for i, mol in enumerate(mols):
            if mol is None:
                continue
            f.write(mol_to_sdf_block(mol, name=f"mol_{i}"))
