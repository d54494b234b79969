"""Drug-likeness properties: QED, synthetic accessibility, Lipinski.

- QED implements Bickerton et al. 2012 with the published ADS parameters
  and mean weights (the same constants RDKit's ``QED.qed`` uses).
- SA implements the Ertl & Schuffenhauer 2009 pipeline, including the
  Morgan-fragment frequency term computed with RDKit-compatible radius-2
  bit hashing (chem/morgan.py) over the published fpscores database
  (``assets/fpscores.npz``; BSD-licensed Novartis data).
- Lipinski reproduces the reference implementation's 5-rule count
  including its ``rule_4`` walrus quirk behind a compat flag.

Float64 Python arithmetic, operation by operation the same as the JAX
package's ``chem/properties.py``: the two must return the same floats
(tests/test_torch_chem_props.py).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from diffndm_tpu_torch.chem.descriptors import (crippen_logp, num_aromatic_rings,
                                          num_hba, num_hbd,
                                          num_rotatable_bonds,
                                          structural_alerts, tpsa)
from diffndm_tpu_torch.chem.mol import Molecule

# ---------------------------------------------------------------------------
# QED (Bickerton et al., Nature Chemistry 2012) — ADS parameters and the
# WEIGHT_MEAN weights as published / used by rdkit.Chem.QED
# ---------------------------------------------------------------------------
_ADS_PARAMS = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353,
           49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897,
              0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202,
            0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001,
            0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614,
            12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000000, 272.4121427, 2.558379970, 1.565547684,
             1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001,
             1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000000, 1199.094025, -0.09002883, 0.000000001,
               0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {"MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
                "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95}


def _ads(x: float, p) -> float:
    a, b, c, d, e, f, dmax = p
    return (a + b / (1 + math.exp(-(x - c + d / 2) / e))
            * (1 - 1 / (1 + math.exp(-(x - c - d / 2) / f)))) / dmax


def qed_properties(mol: Molecule) -> dict:
    return {
        "MW": mol.mol_weight,
        "ALOGP": crippen_logp(mol),
        "HBA": num_hba(mol),
        "HBD": num_hbd(mol),
        "PSA": tpsa(mol),
        "ROTB": num_rotatable_bonds(mol),
        "AROM": num_aromatic_rings(mol),
        "ALERTS": structural_alerts(mol),
    }


def qed(mol: Molecule) -> float:
    """Weighted-mean QED in [0, 1]."""
    props = qed_properties(mol)
    num, den = 0.0, 0.0
    for k, w in _QED_WEIGHTS.items():
        d = max(_ads(props[k], _ADS_PARAMS[k]), 1e-10)
        num += w * math.log(d)
        den += w
    return float(math.exp(num / den))


# ---------------------------------------------------------------------------
# Synthetic accessibility — the Ertl & Schuffenhauer 2009 pipeline
# (sascorer.py) with the real Morgan-fragment frequency database and
# RDKit-compatible radius-2 bit hashing (chem/morgan.py).
# ---------------------------------------------------------------------------

FPSCORES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "fpscores.npz")


@functools.lru_cache(maxsize=None)
def load_fpscores(path: str = FPSCORES):
    """(sorted uint32 bit ids, float32 scores) of the Ertl fragment
    frequency database."""
    with np.load(path) as z:
        return z["bits"], z["scores"]


def _fragment_score(mol: Molecule):
    """Mean fragment-frequency score over the radius-2 Morgan count
    fingerprint; unknown fragments score -4.
    Returns (score1, number of distinct bits)."""
    from diffndm_tpu_torch.chem.morgan import morgan_counts

    fps = morgan_counts(mol, 2)
    bits, scores = load_fpscores()
    ids = np.fromiter(fps.keys(), dtype=np.uint32, count=len(fps))
    cnt = np.fromiter(fps.values(), dtype=np.float64, count=len(fps))
    idx = np.searchsorted(bits, ids)
    idx_c = np.minimum(idx, len(bits) - 1)
    vals = np.where(bits[idx_c] == ids, scores[idx_c].astype(np.float64),
                    -4.0)
    return float((vals * cnt).sum() / cnt.sum()), len(fps)


def _branch_key(mol: Molecule, root: int, banned: int, order: int,
                comp=None):
    """Canonical identity of the branch reachable from ``root`` without
    passing through ``banned`` (WL refinement), tagged with the
    root-to-center bond order — used to compare substituents for potential
    stereocenters the way CIP ranks do.  ``comp`` may carry the branch's
    pre-collected atom list (from _cheap_branch_key)."""
    if comp is None:
        comp = []
        seen = {banned, root}
        stack = [root]
        comp.append(root)
        while stack:
            u = stack.pop()
            for v in mol.neighbors[u]:
                if v not in seen:
                    seen.add(v)
                    comp.append(v)
                    stack.append(v)
    labels = {v: hash((mol.symbols[v], mol.charge(v), mol.implicit_h(v)))
              for v in comp}
    in_comp = set(comp)
    adj = mol.adjacency
    for _ in range(min(len(comp), 12)):
        # hash-compressed WL refinement: labels stay O(1) and remain
        # comparable across branches (equality is what matters here)
        labels = {
            v: hash((labels[v],
                     tuple(sorted((int(adj[v, w]), labels[w])
                                  for w in mol.neighbors[v]
                                  if w in in_comp))))
            for v in comp}
    return (order, labels[root], len(comp),
            tuple(sorted(labels.values())))


def _cheap_branch_key(mol: Molecule, root: int, banned: int, order: int):
    """O(|branch|) invariant of the branch: (bond order, size, sorted
    multiset of (symbol, charge, implicit_h)).  Distinct cheap keys imply
    distinct full WL keys, so pairwise-distinct cheap keys decide a
    stereocenter without any WL refinement (the common case)."""
    comp = []
    seen = {banned, root}
    stack = [root]
    comp.append(root)
    while stack:
        u = stack.pop()
        for v in mol.neighbors[u]:
            if v not in seen:
                seen.add(v)
                comp.append(v)
                stack.append(v)
    sig = sorted((mol.symbols[v], mol.charge(v), mol.implicit_h(v))
                 for v in comp)
    return (order, len(comp), tuple(sig)), comp


def _distinct_branches(mol: Molecule, center: int, roots, extra_h: bool):
    """True iff all branches from ``center`` are pairwise distinct.
    Cheap multiset invariants first; full WL only for colliding pairs."""
    cheap = [_cheap_branch_key(mol, j, center,
                               int(mol.adjacency[center, j]))
             for j in roots]
    keys = [c[0] for c in cheap]
    comps = [c[1] for c in cheap]
    if extra_h:
        keys.append(("H",))
    if len(set(keys)) == len(keys):
        return True
    # collision: compare colliding groups with the full WL key (reusing
    # the component each cheap key already collected)
    groups: dict = {}
    for idx, k in enumerate(keys[:len(roots)]):
        groups.setdefault(k, []).append(idx)
    for k, idxs in groups.items():
        if len(idxs) < 2:
            continue
        full = [_branch_key(mol, roots[i], center,
                            int(mol.adjacency[center, roots[i]]),
                            comp=comps[i])
                for i in idxs]
        if len(set(full)) != len(full):
            return False
    return True


def num_potential_stereocenters(mol: Molecule) -> int:
    """Approximates RDKit ``FindMolChiralCenters(includeUnassigned=True)``:
    atoms whose four substituents (implicit H counts as one) are pairwise
    distinct, plus trivalent P/As with three distinct neighbors
    (lone pair as the fourth group)."""
    n_centers = 0
    for a in range(mol.n_atoms):
        sym = mol.symbols[a]
        deg = mol.degree(a)
        ih = mol.implicit_h(a)
        if sym in ("P", "As") and deg == 3 and ih == 0:
            if _distinct_branches(mol, a, mol.neighbors[a], False):
                n_centers += 1
        elif deg + ih == 4 and ih <= 1 and deg >= 3:
            if sym not in ("C", "Si", "N", "P", "S"):
                continue
            # only charged (quaternary) N is configurationally stable
            if sym == "N" and mol.charge(a) <= 0:
                continue
            if _distinct_branches(mol, a, mol.neighbors[a], ih == 1):
                n_centers += 1
    return n_centers


def _num_spiro_and_bridge(mol: Molecule):
    """RDKit ``CalcNumSpiroAtoms`` / ``CalcNumBridgeheadAtoms``: spiro =
    atom shared by two rings whose intersection is exactly that atom;
    bridgeheads = endpoint atoms of a >=2-bond path shared by two rings
    (e.g. norbornane has 2, a fused bicyclic like naphthalene has 0)."""
    rings = [set(r) for r in mol.rings]
    ring_bonds = []
    for r in mol.rings:
        rs = set(r)
        ring_bonds.append({frozenset((i, j)) for i, j, _ in mol.bonds
                           if i in rs and j in rs})
    spiro, bridge = set(), set()
    for x in range(len(rings)):
        for y in range(x + 1, len(rings)):
            inter = rings[x] & rings[y]
            if len(inter) == 1:
                spiro |= inter
            shared_bonds = ring_bonds[x] & ring_bonds[y]
            if len(shared_bonds) >= 2:
                for a in inter:
                    if sum(1 for b in shared_bonds if a in b) == 1:
                        bridge.add(a)
    return len(spiro), len(bridge)


def sa_score_raw(mol: Molecule) -> float:
    """Ertl raw SA score in [1, 10] (lower = easier), matching
    sascorer.calculateScore term by term."""
    n = mol.n_atoms
    if n == 0:
        return 10.0
    score1, n_distinct_bits = _fragment_score(mol)

    size_penalty = n ** 1.005 - n
    stereo_penalty = math.log10(num_potential_stereocenters(mol) + 1)
    n_spiro, n_bridge = _num_spiro_and_bridge(mol)
    spiro_penalty = math.log10(n_spiro + 1)
    bridge_penalty = math.log10(n_bridge + 1)
    macro_penalty = math.log10(2) if any(len(r) > 8 for r in mol.rings) \
        else 0.0
    score2 = (-size_penalty - stereo_penalty - spiro_penalty
              - bridge_penalty - macro_penalty)

    # fingerprint-density correction for symmetric molecules
    score3 = 0.0
    if n > n_distinct_bits:
        score3 = math.log(float(n) / n_distinct_bits) * 0.5

    sascore = score1 + score2 + score3
    # map to 1..10
    smin, smax = -4.0, 2.5
    sascore = 11.0 - (sascore - smin + 1) / (smax - smin) * 9.0
    if sascore > 8.0:
        sascore = 8.0 + math.log(sascore + 1.0 - 9.0)
    return float(min(max(sascore, 1.0), 10.0))


def sa_score(mol: Molecule) -> float:
    """Normalized SA: (10 - raw)/9 in [0, 1], higher = easier."""
    return round((10.0 - sa_score_raw(mol)) / 9.0, 2)


# ---------------------------------------------------------------------------
# Lipinski rule-of-five count
# ---------------------------------------------------------------------------

def lipinski_count(mol: Molecule, compat_walrus: bool = True) -> int:
    """Number of satisfied rules out of 5.

    compat_walrus=True reproduces the reference's operator-precedence bug:
    ``rule_4 = (logp := MolLogP(m) >= -2) & (logp <= 5)`` binds ``logp`` to
    the *boolean* (MolLogP >= -2), so rule_4 == (logp >= -2) in practice
    (True <= 5 is always True).  False uses the intended -2 <= logp <= 5.
    """
    logp = crippen_logp(mol)
    rule_1 = mol.mol_weight < 500
    rule_2 = num_hbd(mol) <= 5
    rule_3 = num_hba(mol) <= 10
    if compat_walrus:
        rule_4 = logp >= -2
    else:
        rule_4 = -2 <= logp <= 5
    rule_5 = num_rotatable_bonds(mol) <= 10
    return int(sum(bool(r) for r in
                   (rule_1, rule_2, rule_3, rule_4, rule_5)))


def logp(mol: Molecule) -> float:
    return crippen_logp(mol)
