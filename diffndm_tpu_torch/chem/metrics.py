"""Molecule evaluation: properties as the guidance oracle and the
quality evaluation read them, and the reference's evaluation API
(``MoleculeProperties.evaluate`` / ``evaluate_new`` / ``evaluate_mean``,
``BasicMolecularMetrics``, ``CategoricalDistribution``) with the JAX
package's semantics, over this package's ``Molecule`` graphs."""

from __future__ import annotations

from copy import deepcopy
from typing import Optional, Sequence

import numpy as np

from diffndm_tpu_torch.chem import properties as P
from diffndm_tpu_torch.chem.bonds import build_molecule
from diffndm_tpu_torch.chem.fingerprints import diversity, wl_canonical_key
from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.chem.sanitize import (SanitizeError,
                                             connectivity_fraction,
                                             largest_fragment, sanitize)


class CategoricalDistribution:
    """A histogram over categories (atom types) and the KL divergence of
    a sample's histogram from it."""

    EPS = 1e-10

    def __init__(self, histogram_dict: dict, mapping: dict):
        histogram = np.zeros(len(mapping))
        for k, v in histogram_dict.items():
            histogram[mapping[k]] = v
        self.p = histogram / histogram.sum()
        self.mapping = deepcopy(mapping)

    def kl_divergence(self, other_sample: Sequence[int]) -> float:
        """-sum p log(q / p + eps) over the bins with p > 0 (an empty bin
        adds 0 and no warning); nan for an empty sample."""
        sample = np.zeros(len(self.mapping))
        for x in other_sample:
            sample[x] += 1
        if sample.sum() == 0:
            return float("nan")
        q = sample / sample.sum()
        nz = self.p > 0
        return float(-np.sum(self.p[nz]
                             * np.log(q[nz] / self.p[nz] + self.EPS)))


class MoleculeProperties:
    """QED / SA / LogP / Lipinski of one (sanitized) molecule, diversity
    of a set, and the per-pocket evaluations."""

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

    @classmethod
    def calculate_diversity(cls, pocket_mols: Sequence[Molecule]) -> float:
        return diversity(list(pocket_mols))

    def evaluate(self, pocket_rdmols: Sequence[Sequence[Molecule]]):
        """Per pocket, the properties of its valid molecules (invalid
        ones dropped, pockets with none left out) and their diversity:
        (qed, sa, logp, lipinski) lists of lists and a diversity list."""
        all_qed, all_sa, all_logp, all_lip, per_div = [], [], [], [], []
        for pocket in pocket_rdmols:
            valid = []
            for mol in pocket:
                try:
                    sanitize(mol)
                    valid.append(mol)
                except SanitizeError:
                    continue
            if valid:
                all_qed.append([self.calculate_qed(m) for m in valid])
                all_sa.append([self.calculate_sa(m) for m in valid])
                all_logp.append([self.calculate_logp(m) for m in valid])
                all_lip.append([self.calculate_lipinski(m) for m in valid])
                per_div.append(self.calculate_diversity(valid))
        return all_qed, all_sa, all_logp, all_lip, per_div

    def evaluate_new(self, pocket_rdmols: Sequence[Sequence[Molecule]]):
        """Flat per-molecule properties over all pockets, 0 in every term
        for a missing or invalid molecule: ([qed], [sa], [logp],
        [lipinski])."""
        all_qed, all_sa, all_logp, all_lip = [], [], [], []
        for pocket in pocket_rdmols:
            for mol in pocket:
                try:
                    if mol is None:
                        raise SanitizeError("missing molecule")
                    sanitize(mol)
                    all_qed.append(self.calculate_qed(mol))
                    all_sa.append(self.calculate_sa(mol))
                    all_logp.append(self.calculate_logp(mol))
                    all_lip.append(self.calculate_lipinski(mol))
                except SanitizeError:
                    all_qed.append(0)
                    all_sa.append(0)
                    all_logp.append(0)
                    all_lip.append(0)
        return [all_qed], [all_sa], [all_logp], [all_lip]

    def evaluate_mean(self, rdmols: Sequence[Molecule]):
        """Mean QED, SA, LogP and Lipinski of the molecules and their
        diversity; zeros for none."""
        if len(rdmols) < 1:
            return 0.0, 0.0, 0.0, 0.0, 0.0
        return (float(np.mean([self.calculate_qed(m) for m in rdmols])),
                float(np.mean([self.calculate_sa(m) for m in rdmols])),
                float(np.mean([self.calculate_logp(m) for m in rdmols])),
                float(np.mean([self.calculate_lipinski(m) for m in rdmols])),
                self.calculate_diversity(rdmols))


class BasicMolecularMetrics:
    """Validity, connectivity, uniqueness and novelty of generated
    molecules.  Identity is ``wl_canonical_key`` of the largest fragment
    (where the reference compares canonical SMILES); novelty is against
    ``dataset_smiles_list``, a list of such keys."""

    def __init__(self, dataset_info: dict,
                 dataset_smiles_list: Optional[Sequence[str]] = None,
                 connectivity_thresh: float = 1.0):
        self.atom_decoder = dataset_info["atom_decoder"]
        self.dataset_smiles_list = (set(dataset_smiles_list)
                                    if dataset_smiles_list is not None
                                    else None)
        self.dataset_info = dataset_info
        self.connectivity_thresh = connectivity_thresh

    def compute_validity(self, generated: Sequence[Molecule]):
        if len(generated) < 1:
            return [], 0.0
        valid = []
        for mol in generated:
            try:
                sanitize(mol)
                valid.append(mol)
            except SanitizeError:
                continue
        return valid, len(valid) / len(generated)

    def compute_connectivity(self, valid: Sequence[Molecule]):
        """(largest fragments of the molecules at or above the threshold,
        their share, their keys)."""
        if len(valid) < 1:
            return [], 0.0, []
        connected, keys = [], []
        for mol in valid:
            if connectivity_fraction(mol) >= self.connectivity_thresh:
                largest = largest_fragment(mol)
                connected.append(largest)
                keys.append(wl_canonical_key(largest))
        return connected, len(keys) / len(valid), keys

    def compute_uniqueness(self, keys: Sequence[str]):
        if len(keys) < 1:
            return [], 0.0
        return list(set(keys)), len(set(keys)) / len(keys)

    def compute_novelty(self, unique: Sequence[str]):
        if len(unique) < 1 or self.dataset_smiles_list is None:
            return [], 0.0
        novel = [k for k in unique if k not in self.dataset_smiles_list]
        return novel, len(novel) / len(unique)

    def evaluate_rdmols(self, mols: Sequence[Molecule]):
        """([validity, connectivity, uniqueness, novelty], [valid,
        connected])."""
        valid, validity = self.compute_validity(mols)
        connected, connectivity, keys = self.compute_connectivity(valid)
        unique, uniqueness = self.compute_uniqueness(keys)
        _, novelty = self.compute_novelty(unique)
        return ([validity, connectivity, uniqueness, novelty],
                [valid, connected])

    def evaluate(self, generated):
        """generated: (positions, atom type indices) pairs, bonds
        perceived here."""
        mols = [build_molecule(pos, types, self.dataset_info)
                for pos, types in generated]
        return self.evaluate_rdmols(mols)


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
