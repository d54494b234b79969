"""Molecule properties as the guidance oracle and the quality evaluation
read them."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from diffndm_tpu_torch.chem import properties as P
from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.chem.sanitize import (SanitizeError,
                                             connectivity_fraction,
                                             largest_fragment, sanitize)


class MoleculeProperties:
    """QED / SA / LogP / Lipinski of one (sanitized) molecule."""

    @staticmethod
    def calculate_qed(mol: Molecule) -> float:
        return P.qed(mol)

    @staticmethod
    def calculate_sa(mol: Molecule) -> float:
        return P.sa_score(mol)

    @staticmethod
    def calculate_logp(mol: Molecule) -> float:
        return P.logp(mol)

    @staticmethod
    def calculate_lipinski(mol: Molecule) -> int:
        return P.lipinski_count(mol)


def quality_summary(mols: Sequence[Molecule]) -> dict:
    """Sample quality of generated molecules by the reference evaluation
    protocol: the largest fragment of each molecule is scored, and a
    molecule is valid when that fragment sanitizes.  ``connectivity`` is
    the mean largest-fragment share over all molecules, before any
    extraction, and ``connected`` the share that are one fragment; QED,
    SA, LogP and Lipinski are means over the valid molecules."""
    props = MoleculeProperties()
    rows, conn = [], []
    for mol in mols:
        conn.append(connectivity_fraction(mol))
        frag = largest_fragment(mol)
        try:
            sanitize(frag)
        except SanitizeError:
            continue
        rows.append((props.calculate_qed(frag), props.calculate_sa(frag),
                     props.calculate_logp(frag),
                     props.calculate_lipinski(frag)))
    arr = np.asarray(rows, float) if rows else np.zeros((1, 4))
    return {
        "n": len(mols),
        "valid": len(rows) / max(len(mols), 1),
        "connectivity": float(np.mean(conn)) if conn else 0.0,
        "connected": (float(np.mean([c >= 1.0 for c in conn]))
                      if conn else 0.0),
        "qed": float(arr[:, 0].mean()),
        "sa": float(arr[:, 1].mean()),
        "logp": float(arr[:, 2].mean()),
        "lipinski": float(arr[:, 3].mean()),
    }
