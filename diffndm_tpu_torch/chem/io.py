"""Molecule files: SDF (V2000), writing and a minimal reader; XYZ."""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def read_sdf(path: str) -> List[Molecule]:
    """Minimal V2000 reader: symbols, coordinates and bonds of each record
    (an aromatic bond, order 4, is read as a single bond)."""
    mols = []
    with open(path) as f:
        blocks = f.read().split("$$$$")
    for block in blocks:
        lines = block.splitlines()
        # drop a leading newline left by the $$$$ split, keeping the
        # 3-line header + counts alignment intact
        while lines and not lines[0].strip() and len(lines) > 4 and \
                "V2000" not in lines[3]:
            lines.pop(0)
        if len(lines) < 4:
            continue
        # the counts line (header lines may themselves be blank)
        counts_idx = next((k for k in range(min(8, len(lines)))
                           if "V2000" in lines[k]), 3)
        counts = lines[counts_idx]
        try:
            n_atoms = int(counts[0:3])
            n_bonds = int(counts[3:6])
        except (ValueError, IndexError):
            continue
        coords, symbols, bonds = [], [], []
        lines = lines[counts_idx - 3:]
        for ln in lines[4:4 + n_atoms]:
            coords.append([float(ln[0:10]), float(ln[10:20]),
                           float(ln[20:30])])
            symbols.append(ln[31:34].strip())
        for ln in lines[4 + n_atoms:4 + n_atoms + n_bonds]:
            i, j, o = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
            bonds.append((i, j, 1 if o == 4 else min(o, 3)))
        mols.append(Molecule(symbols, bonds,
                             coords=np.array(coords, np.float64)))
    return mols


def write_xyz(path: str, coords: np.ndarray, symbols: Sequence[str]) -> None:
    """An XYZ file: the atom count, an empty comment line, then one
    ``symbol x y z`` line per atom (Angstroms, 9 decimals)."""
    with open(path, "w") as f:
        f.write(f"{len(symbols)}\n\n")
        for (x, y, z), s in zip(coords, symbols):
            f.write(f"{s} {x:.9f} {y:.9f} {z:.9f}\n")


def read_xyz(path: str):
    """(coords [n, 3] float64, symbols) of an XYZ file."""
    with open(path) as f:
        lines = f.read().strip().splitlines()
    n = int(lines[0])
    symbols, coords = [], []
    for line in lines[2:2 + n]:
        parts = line.split()
        symbols.append(parts[0])
        coords.append([float(v) for v in parts[1:4]])
    return np.array(coords), symbols
