"""Minimal PDB parser (fixed-column ATOM/HETATM records).

What pocket extraction needs: residues with their atoms' names, elements
and coordinates, the CA lookup and the standard-amino-acid test.  The
rules are the JAX package's ``data/pdb.py``:

- only the first alternate location ("" or "A") of an atom is kept;
- a residue is keyed by (chain, number, insertion code, name);
- ``MODEL`` sets the model number (or counts up when it has none),
  ``ENDMDL`` counts up, and only the requested model's records are read;
- a blank element column falls back to the atom-name columns, where two
  letters make the element only when the second is lower case.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffndm_tpu_torch.constants import AA_3TO1, STANDARD_AA


@dataclass
class Atom:
    name: str
    element: str
    coord: np.ndarray
    is_hetero: bool = False
    altloc: str = ""


@dataclass
class Residue:
    chain: str
    resi: int
    resname: str
    icode: str = ""
    atoms: List[Atom] = field(default_factory=list)

    @property
    def is_standard_aa(self) -> bool:
        return self.resname in STANDARD_AA

    @property
    def one_letter(self) -> Optional[str]:
        return AA_3TO1.get(self.resname)

    def get_atom(self, name: str) -> Optional[Atom]:
        for a in self.atoms:
            if a.name == name:
                return a
        return None

    @property
    def ca(self) -> Optional[Atom]:
        return self.get_atom("CA")

    def coords(self) -> np.ndarray:
        return np.array([a.coord for a in self.atoms])


@dataclass
class PDBStructure:
    residues: List[Residue]

    def chains(self) -> Dict[str, List[Residue]]:
        out: Dict[str, List[Residue]] = {}
        for r in self.residues:
            out.setdefault(r.chain, []).append(r)
        return out

    def get_residue(self, chain: str, resi: int) -> Residue:
        found = [r for r in self.residues
                 if r.chain == chain and r.resi == resi]
        if len(found) != 1:
            raise ValueError(f"{len(found)} residues match {chain}:{resi}")
        return found[0]


def _element_from_record(line: str) -> str:
    el = line[76:78].strip() if len(line) >= 78 else ""
    if not el:
        el = line[12:16].strip(" 0123456789")[:2]
        if not (len(el) == 2 and el[1].islower()):
            el = el[:1]
    return el.capitalize()


def parse_pdb(path: str, model: int = 1) -> PDBStructure:
    """Parse the first (or the given) MODEL of a PDB file."""
    residues: Dict[Tuple[str, int, str, str], Residue] = {}
    current_model = 1
    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec.startswith("MODEL"):
                try:
                    current_model = int(line.split()[1])
                except (IndexError, ValueError):
                    current_model += 1
                continue
            if rec.startswith("ENDMDL"):
                current_model += 1
                continue
            if rec not in ("ATOM  ", "HETATM") or current_model != model:
                continue
            altloc = line[16].strip()
            if altloc not in ("", "A"):
                continue
            resname = line[17:20].strip()
            chain = line[21].strip() or " "
            try:
                resi = int(line[22:26])
            except ValueError:
                continue
            icode = line[26].strip()
            coord = np.array([float(line[30:38]), float(line[38:46]),
                              float(line[46:54])])
            key = (chain, resi, icode, resname)
            if key not in residues:
                residues[key] = Residue(chain=chain, resi=resi,
                                        resname=resname, icode=icode)
            residues[key].atoms.append(
                Atom(name=line[12:16].strip(),
                     element=_element_from_record(line), coord=coord,
                     is_hetero=rec.startswith("HETATM"), altloc=altloc))
    return PDBStructure(list(residues.values()))
