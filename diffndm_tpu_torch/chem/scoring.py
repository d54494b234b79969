"""Native Vina-style protein-ligand scoring.

The published AutoDock Vina empirical scoring function (Trott & Olson,
J Comput Chem 2010: weighted gauss / repulsion / hydrophobic / H-bond
terms over heavy-atom pairs with an N_rot penalty) on this package's
Molecule and PDB types, so that affinity estimates need no external
binary.  It rescores a pose as it stands (the analogue of ``smina
--score_only``); ``chem/dock.py`` searches poses over the same terms.

Approximations against Vina's full atom typing (deliberate):
- donors/acceptors are typed, not guessed from the element: ligand
  donors/acceptors come from topology (implicit-H count from valence;
  O always accepts, N accepts when it has a free lone pair), receptor
  donors/acceptors from amino-acid residue templates (backbone N donates
  except in PRO, backbone O accepts, side chains per the standard table);
- hydrophobic carbon: a carbon with no N/O within covalent range
  (inferred from geometry, 1.75 A), for ligand and receptor alike;
- no intramolecular term (score_only's dominant component is the
  intermolecular one).

Scores correlate with smina affinities but are not equal to them;
``chem/docking.py`` wraps the binaries where they exist.  Host NumPy,
operation by operation the same as the JAX package's ``chem/scoring.py``:
the two return the same floats (tests/test_torch_scoring.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from diffndm_tpu_torch.chem.mol import Molecule

# Vina weights (Trott & Olson 2010, table 1)
W_GAUSS1 = -0.035579
W_GAUSS2 = -0.005156
W_REPULSION = 0.840245
W_HYDROPHOBIC = -0.035069
W_HBOND = -0.587439
W_NROT = 0.05846

# X-Score vdW radii used by Vina (A)
_RADII = {"C": 1.9, "N": 1.8, "O": 1.7, "S": 2.0, "P": 2.1, "F": 1.5,
          "Cl": 1.8, "Br": 2.0, "I": 2.2, "Si": 2.2, "B": 2.0}
_DEFAULT_RADIUS = 1.9
_CUTOFF = 8.0  # pair cutoff (A), as in Vina


def _atom_properties(coords: np.ndarray, elements: Sequence[str]):
    """(radii, hydrophobic, polar) arrays for a heavy-atom point cloud.

    Hydrophobic: C/F/Cl/Br/I, with carbons demoted when a N/O sits within
    covalent range (1.75 A).  Polar (donor/acceptor): N or O.
    """
    n = len(elements)
    radii = np.array([_RADII.get(e, _DEFAULT_RADIUS) for e in elements])
    elements = np.asarray(elements)
    polar = (elements == "N") | (elements == "O")
    hydro = np.isin(elements, ("C", "F", "Cl", "Br", "I"))
    carbons = np.where(elements == "C")[0]
    if len(carbons) and polar.any():
        d = np.linalg.norm(coords[carbons][:, None]
                           - coords[polar][None], axis=-1)
        hydro[carbons[(d < 1.75).any(axis=1)]] = False
    return radii, hydro, polar


# Residue-template H-bond typing for noH protein structures.  Backbone N
# donates (except PRO), backbone O/OXT accepts; side chains below.  Any
# other polar receptor atom (non-standard residues kept by the caller)
# falls back to donor+acceptor.
_SC_DONORS = {
    "SER": {"OG"}, "THR": {"OG1"}, "TYR": {"OH"},
    "ASN": {"ND2"}, "GLN": {"NE2"},
    "HIS": {"ND1", "NE2"}, "LYS": {"NZ"},
    "ARG": {"NE", "NH1", "NH2"}, "TRP": {"NE1"},
}
_SC_ACCEPTORS = {
    "SER": {"OG"}, "THR": {"OG1"}, "TYR": {"OH"},
    "ASN": {"OD1"}, "GLN": {"OE1"},
    "ASP": {"OD1", "OD2"}, "GLU": {"OE1", "OE2"},
    "HIS": {"ND1", "NE2"},
}


def residue_hbond_types(resname: str, atom_name: str, element: str
                        ) -> tuple:
    """(donor, acceptor) for one receptor heavy atom by residue template."""
    if element not in ("N", "O"):
        return False, False
    if atom_name == "N":          # backbone amide N
        return resname != "PRO", False
    if atom_name in ("O", "OXT"):  # backbone carbonyl / terminus
        return False, True
    don = atom_name in _SC_DONORS.get(resname, ())
    acc = atom_name in _SC_ACCEPTORS.get(resname, ())
    if not don and not acc:       # unknown polar atom: permissive fallback
        return True, True
    return don, acc


def geometric_base_dirs(coords: np.ndarray, cutoff: float = 1.8):
    """Unit "base direction" per atom: away from the mean of covalently
    bonded neighbours (heavy atoms within `cutoff`).  Zero rows mean "no
    direction available" (isolated atom) — callers treat those as
    direction-free (weight 1).  Used for directional H-bond weighting on
    the rigid receptor, where bonds are inferred geometrically."""
    x = np.asarray(coords, float)
    d = np.linalg.norm(x[:, None] - x[None], axis=-1)
    nb = (d < cutoff) & (d > 0.1)
    dirs = np.zeros_like(x)
    cnt = nb.sum(1)
    has = cnt > 0
    if has.any():
        mean_nb = (nb[..., None] * x[None]).sum(1)[has] / cnt[has, None]
        v = x[has] - mean_nb
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        dirs[has] = np.where(n > 1e-9, v / np.maximum(n, 1e-9), 0.0)
    return dirs


def neighbor_mean_operator(mol: Molecule):
    """Row-normalised adjacency A ([N, N], float32) and has-neighbour
    mask: ``A @ x`` is the bonded-neighbour centroid per atom, so
    ``normalize(x - A @ x)`` gives pose-covariant ligand base directions
    for directional H-bond weighting — differentiable through the pose
    transform (chem/dock.py optimises through it)."""
    n = mol.n_atoms
    A = np.zeros((n, n), np.float32)
    for i, j, _ in mol.bonds:
        A[i, j] = 1.0
        A[j, i] = 1.0
    cnt = A.sum(1)
    has = cnt > 0
    A[has] /= cnt[has, None]
    return A, has


def hbond_direction_weight(lig_x, lig_dir, lig_has, rec_x, rec_dir,
                           rec_has, d):
    """[N, R] directional weight for the hbond term: product of the
    alignment of the ligand->receptor axis with each side's base
    direction, clipped to [0, 1]; sides without a direction contribute
    1 (distance-only fallback).  NumPy arrays; the pose search takes
    ``hbond_direction_weight_torch``."""
    u = (rec_x[None] - lig_x[:, None]) / np.maximum(d[..., None], 1e-9)
    wl = np.clip((u * lig_dir[:, None]).sum(-1), 0.0, 1.0)
    wr = np.clip((-u * rec_dir[None]).sum(-1), 0.0, 1.0)
    wl = np.where(lig_has[:, None], wl, 1.0)
    wr = np.where(rec_has[None], wr, 1.0)
    return wl * wr


def hbond_direction_weight_torch(lig_x, lig_dir, lig_has, rec_x, rec_dir,
                                 rec_has, d):
    """``hbond_direction_weight`` on tensors, with leading batch dims:
    lig_x, lig_dir [..., N, 3], lig_has [..., N], rec_x, rec_dir
    [..., R, 3], rec_has [..., R], d [..., N, R] -> [..., N, R].  The
    same operations in the same order, differentiable in lig_x, lig_dir
    and d."""
    u = ((rec_x[..., None, :, :] - lig_x[..., :, None, :])
         / d[..., None].clamp_min(1e-9))
    wl = (u * lig_dir[..., :, None, :]).sum(-1).clamp(0.0, 1.0)
    wr = (-u * rec_dir[..., None, :, :]).sum(-1).clamp(0.0, 1.0)
    wl = wl.where(lig_has[..., :, None], 1.0)
    wr = wr.where(rec_has[..., None, :], 1.0)
    return wl * wr


def ligand_hbond_types(mol: Molecule):
    """(donor[N], acceptor[N]) bool arrays from ligand topology.

    Implicit-H count = default valence (O:2, N:3) + formal charge − total
    bond order; a polar atom with an implicit H donates.  O always
    accepts; N accepts when it is not a donor and has a free lone pair
    (degree <= 2: pyridine/imine/nitrile — matches AutoDock's NA typing;
    tertiary/aromatic-substituted N does not accept)."""
    n = mol.n_atoms
    don = np.zeros(n, bool)
    acc = np.zeros(n, bool)
    order = np.zeros(n, int)
    deg = np.zeros(n, int)
    for i, j, o in mol.bonds:
        order[i] += o
        order[j] += o
        deg[i] += 1
        deg[j] += 1
    for i, s in enumerate(mol.symbols):
        q = mol.charge(i)
        if s == "O":
            acc[i] = True
            don[i] = (2 + q - order[i]) > 0
        elif s == "N":
            don[i] = (3 + q - order[i]) > 0
            acc[i] = (not don[i]) and deg[i] <= 2
    return don, acc


class VinaScorer:
    """Rescoring of ligand poses against a fixed receptor point cloud."""

    def __init__(self, receptor_coords: np.ndarray,
                 receptor_elements: Sequence[str],
                 donors: np.ndarray = None, acceptors: np.ndarray = None,
                 directional_hbond: bool = True):
        keep = [i for i, e in enumerate(receptor_elements) if e != "H"]
        self.rec_x = np.asarray(receptor_coords, float)[keep]
        elems = [receptor_elements[i] for i in keep]
        self.rec_r, self.rec_hydro, self.rec_polar = _atom_properties(
            self.rec_x, elems)
        # H-bond typing: the raw point-cloud constructor has no residue
        # info, so polar atoms default to donor+acceptor; from_pdb
        # installs the residue-template typing.
        self.rec_donor = (self.rec_polar.copy() if donors is None
                          else np.asarray(donors, bool)[keep])
        self.rec_acceptor = (self.rec_polar.copy() if acceptors is None
                             else np.asarray(acceptors, bool)[keep])
        # directional H-bonding: weight each donor-acceptor pair by the
        # alignment of the D->A axis with both atoms' base directions
        # (distance-only Vina misranks flipped poses that pile polar
        # contacts at the wrong geometry); atoms with no bonded neighbour
        # keep weight 1, so bare point clouds are unaffected.
        self.directional_hbond = bool(directional_hbond)
        self.rec_hdir = geometric_base_dirs(self.rec_x)
        self.rec_hdir_has = np.linalg.norm(self.rec_hdir, axis=-1) > 0.5

    @classmethod
    def from_pdb(cls, pdb_path: str,
                 protein_only: bool = True) -> "VinaScorer":
        """protein_only keeps standard amino-acid residues — HETATM
        ligands/waters in the same file would otherwise clash against the
        pose being scored."""
        from diffndm_tpu_torch.data.pdb import parse_pdb

        coords, elems, don, acc = [], [], [], []
        for res in parse_pdb(pdb_path).residues:
            if protein_only and not res.is_standard_aa:
                continue
            for a in res.atoms:
                coords.append(a.coord)
                elems.append(a.element)
                d, c = residue_hbond_types(res.resname, a.name, a.element)
                don.append(d)
                acc.append(c)
        return cls(np.asarray(coords), elems,
                   donors=np.asarray(don), acceptors=np.asarray(acc))

    def interaction_terms(self, mol: Molecule) -> dict:
        """Per-term sums over ligand-receptor heavy-atom pairs."""
        lig_x = np.asarray(mol.coords, float)
        lig_r, lig_hydro, lig_polar = _atom_properties(lig_x, mol.symbols)
        if mol.bonds:
            lig_don, lig_acc = ligand_hbond_types(mol)
        else:  # bare point cloud: no topology to type from
            lig_don = lig_acc = lig_polar

        d = np.linalg.norm(lig_x[:, None] - self.rec_x[None], axis=-1)
        within = d < _CUTOFF
        if not within.any():
            return {"gauss1": 0.0, "gauss2": 0.0, "repulsion": 0.0,
                    "hydrophobic": 0.0, "hbond": 0.0}
        # surface distance d' = d - (R_i + R_j)
        ds = d - (lig_r[:, None] + self.rec_r[None])
        ds = np.where(within, ds, np.inf)

        gauss1 = np.exp(-((ds / 0.5) ** 2))
        gauss2 = np.exp(-(((ds - 3.0) / 2.0) ** 2))
        repulsion = np.where(ds < 0, ds ** 2, 0.0)
        # hydrophobic: 1 below 0.5, 0 above 1.5, linear between; only for
        # hydrophobic-hydrophobic pairs
        h = np.clip((1.5 - ds), 0.0, 1.0)
        h = np.where(ds < 0.5, 1.0, h)
        h = h * (lig_hydro[:, None] & self.rec_hydro[None])
        # hbond: 1 below -0.7, 0 above 0, linear between; only for
        # donor-acceptor pairs (either direction)
        g = np.clip(-ds / 0.7, 0.0, 1.0)
        g = g * ((lig_don[:, None] & self.rec_acceptor[None])
                 | (lig_acc[:, None] & self.rec_donor[None]))
        if self.directional_hbond and (lig_don.any() or lig_acc.any()):
            if mol.bonds:
                A, lig_has = neighbor_mean_operator(mol)
                v = lig_x - A @ lig_x
                nv = np.linalg.norm(v, axis=-1, keepdims=True)
                lig_dir = np.where(nv > 1e-9, v / np.maximum(nv, 1e-9),
                                   0.0)
                lig_has = lig_has & (nv[:, 0] > 1e-9)
            else:
                lig_dir = np.zeros_like(lig_x)
                lig_has = np.zeros(len(lig_x), bool)
            g = g * hbond_direction_weight(
                lig_x, lig_dir, lig_has, self.rec_x, self.rec_hdir,
                self.rec_hdir_has, d)

        m = within
        return {"gauss1": float(gauss1[m].sum()),
                "gauss2": float(gauss2[m].sum()),
                "repulsion": float(repulsion[m].sum()),
                "hydrophobic": float(h[m].sum()),
                "hbond": float(g[m].sum())}

    def score(self, mol: Molecule) -> float:
        """Vina-style affinity estimate (kcal/mol scale; lower=better)."""
        from diffndm_tpu_torch.chem.descriptors import num_rotatable_bonds

        t = self.interaction_terms(mol)
        inter = (W_GAUSS1 * t["gauss1"] + W_GAUSS2 * t["gauss2"]
                 + W_REPULSION * t["repulsion"]
                 + W_HYDROPHOBIC * t["hydrophobic"]
                 + W_HBOND * t["hbond"])
        n_rot = num_rotatable_bonds(mol)
        return inter / (1.0 + W_NROT * n_rot)


def calibrate_against_smina(receptor_pdb: str, sdf_paths: Sequence[str]
                            ) -> dict:
    """Fit per-term scales of the native scoring function against smina
    ``--score_only`` affinities.

    Requires the smina binary (chem/docking.py); raises
    DockingUnavailable otherwise.  Returns
    ``{"weights": {term: w}, "nrot_w": w, "r2": float, "n": int}`` from a
    least-squares fit of ``affinity * (1 + w_rot * n_rot) ~= sum_k w_k
    term_k`` over the given ligand poses.  Until a calibration has been
    run on a machine with the binaries, native scores carry the published
    Trott-Olson weights and are labeled UNCALIBRATED in evaluate output.
    """
    from diffndm_tpu_torch.chem.descriptors import num_rotatable_bonds
    from diffndm_tpu_torch.chem.docking import smina_score
    from diffndm_tpu_torch.chem.io import read_sdf

    scorer = VinaScorer.from_pdb(receptor_pdb)
    terms, y = [], []
    names = ("gauss1", "gauss2", "repulsion", "hydrophobic", "hbond")
    affinities = smina_score(list(sdf_paths), receptor_pdb)
    for path, aff in zip(sdf_paths, affinities):
        if not np.isfinite(aff):
            continue
        for mol in read_sdf(path):
            t = scorer.interaction_terms(mol)
            n_rot = num_rotatable_bonds(mol)
            terms.append([t[k] for k in names])
            y.append(aff * (1.0 + W_NROT * n_rot))
            break  # smina reports the first pose per file
    if len(y) < len(names):
        raise ValueError(f"need >= {len(names)} scored poses, "
                         f"got {len(y)}")
    A = np.asarray(terms, float)
    yv = np.asarray(y, float)
    w, *_ = np.linalg.lstsq(A, yv, rcond=None)
    pred = A @ w
    ss_res = float(((yv - pred) ** 2).sum())
    ss_tot = float(((yv - yv.mean()) ** 2).sum()) or 1.0
    return {"weights": dict(zip(names, w.tolist())), "nrot_w": W_NROT,
            "r2": 1.0 - ss_res / ss_tot, "n": len(y)}


def vina_score_like(mols: Sequence[Molecule], receptor_pdb: str
                    ) -> List[float]:
    """Affinity estimates for a list of molecules against a receptor PDB
    — the native stand-in for docking.smina_score when no binaries exist
    (NaN for None entries, mirroring the reference's failure behaviour)."""
    scorer = VinaScorer.from_pdb(receptor_pdb)
    return [scorer.score(m) if m is not None else float("nan")
            for m in mols]
