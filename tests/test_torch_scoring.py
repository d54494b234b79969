"""The port's rescoring (diffndm_tpu_torch/chem/scoring.py), symmetry RMSD
(chem/rmsd.py) and the oracle's affinity term against the JAX package's,
on the same inputs, with exact equality:

- ``VinaScorer.interaction_terms`` and ``score`` on the carbon slab of
  tests/test_scoring.py and on test pockets of data/processed/virtual_v3
  written as PDB (one ALA residue per atom) with their ligands (bonds
  perceived, and as bare point clouds), with and without directional
  H-bonds; a seeded receptor of standard residues with a HETATM ligand and
  waters read with and without ``protein_only``;
- ``residue_hbond_types`` over every standard residue x every atom name x
  element; ``vina_score_like`` with None rows;
- ``graph_automorphisms`` counts and ``symmetry_rmsd`` on symmetric
  molecules;
- the oracle's rewards with a receptor set and w_vina 0.1, at 0 and 4
  workers and with both scorers, ``==`` JAX's ``score_batch_types``; with
  w_vina 0 the receptor changes nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import rmsd as jrmsd  # noqa: E402
from diffndm_tpu.chem import scoring as js  # noqa: E402
from diffndm_tpu.chem.mol import Molecule as JMol  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.guidance.oracle import \
    RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu_torch.chem import rmsd as trmsd  # noqa: E402
from diffndm_tpu_torch.chem import scoring as ts  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402

INFO = dataset_params["crossdock_full"]
PAIRS = (220, 48, 0, 29, 52, 101)
# heavy atoms of the standard residues, PDB names
RESIDUES = {
    "ALA": "N CA C O CB", "ARG": "N CA C O CB CG CD NE CZ NH1 NH2",
    "ASN": "N CA C O CB CG OD1 ND2", "ASP": "N CA C O CB CG OD1 OD2",
    "CYS": "N CA C O CB SG", "GLN": "N CA C O CB CG CD OE1 NE2",
    "GLU": "N CA C O CB CG CD OE1 OE2", "GLY": "N CA C O",
    "HIS": "N CA C O CB CG ND1 CD2 CE1 NE2",
    "ILE": "N CA C O CB CG1 CG2 CD1", "LEU": "N CA C O CB CG CD1 CD2",
    "LYS": "N CA C O CB CG CD CE NZ", "MET": "N CA C O CB CG SD CE",
    "PHE": "N CA C O CB CG CD1 CD2 CE1 CE2 CZ", "PRO": "N CA C O CB CG CD",
    "SER": "N CA C O CB OG", "THR": "N CA C O CB OG1 CG2",
    "TRP": "N CA C O CB CG CD1 CD2 NE1 CE2 CE3 CZ2 CZ3 CH2",
    "TYR": "N CA C O CB CG CD1 CD2 CE1 CE2 CZ OH",
    "VAL": "N CA C O CB CG1 CG2"}


def atom_line(rec, serial, name, resname, resi, c, el):
    return (f"{rec:<6}{serial:>5} {name:<4} {resname:>3} A{resi:>4}    "
            f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
            f"          {el:>2}")


def pocket_pdb(pair, path):
    """A test pocket as PDB: one ALA residue per atom, named by its
    element (backbone N / O typing for the polar atoms)."""
    lines = []
    for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                    pair.pocket_one_hot)):
        el = INFO["atom_decoder"][int(oh.argmax())].upper()
        lines.append(atom_line("ATOM", i + 1, el, "ALA", i + 1, c, el))
    path.write_text("\n".join(lines + ["END"]) + "\n")
    return str(path)


def residue_pdb(path, seed=0):
    """A seeded receptor of standard residues (each a 1.5 A random walk
    from a 6 A lattice site), one HETATM ligand residue and two waters."""
    rng = np.random.default_rng(seed)
    lines, serial = [], 0
    names = sorted(RESIDUES)
    sites = np.stack(np.meshgrid(*[np.arange(3) * 6.0] * 3), -1).reshape(
        -1, 3)
    for resi, site in enumerate(sites, 1):
        resname = names[(resi - 1) % len(names)]
        pos = site.copy()
        for name in RESIDUES[resname].split():
            serial += 1
            lines.append(atom_line("ATOM", serial, name, resname, resi, pos,
                                   name[0]))
            step = rng.normal(size=3)
            pos = pos + 1.5 * step / np.linalg.norm(step)
    for k, (resname, atoms) in enumerate(
            (("LIG", "C1 C2 O1 N1"), ("HOH", "O"), ("HOH", "O"))):
        pos = np.array([6.0, 6.0, 6.0]) + rng.normal(size=3)
        for name in atoms.split():
            serial += 1
            lines.append(atom_line("HETATM", serial, name, resname,
                                   100 + k, pos, name[0]))
            pos = pos + np.array([1.4, 0.3, 0.0])
    path.write_text("\n".join(lines + ["END"]) + "\n")
    return str(path)


def to_jax(m):
    return JMol(list(m.symbols), list(m.bonds),
                coords=None if m.coords is None else np.asarray(m.coords),
                charges=m.charges)


def scorer_state(sc):
    return [sc.rec_x, sc.rec_r, sc.rec_hydro, sc.rec_polar, sc.rec_donor,
            sc.rec_acceptor, sc.rec_hdir, sc.rec_hdir_has]


def assert_same_scorer(a, b):
    for x, y in zip(scorer_state(a), scorer_state(b)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.directional_hbond == b.directional_hbond


def assert_same_scores(port, ref, mol):
    assert port.interaction_terms(mol) == ref.interaction_terms(to_jax(mol))
    assert port.score(mol) == ref.score(to_jax(mol))


@pytest.fixture(scope="module")
def dataset():
    return ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")


def ligand(pair, bonds=True):
    m = build_molecule(pair.lig_coords, pair.lig_one_hot.argmax(1), INFO)
    return m if bonds else Molecule(m.symbols, [], coords=m.coords)


@pytest.mark.parametrize("directional", [True, False])
def test_slab_terms_and_scores_equal_jax(dataset, directional):
    xs, ys = np.meshgrid(np.arange(-6, 7, 1.5), np.arange(-6, 7, 1.5))
    coords = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], -1)
    port = ts.VinaScorer(coords, ["C"] * len(coords),
                         directional_hbond=directional)
    ref = js.VinaScorer(coords, ["C"] * len(coords),
                        directional_hbond=directional)
    assert_same_scorer(port, ref)
    mols = [Molecule(["C", "C"], [(0, 1, 1)],
                     coords=np.array([[0.0, 0, z], [1.5, 0, z]]))
            for z in (0.5, 4.0, 50.0)]
    for i in (0, 29, 52):
        m = ligand(dataset[i])
        m.coords = m.coords - m.coords.mean(0) + [0.0, 0.0, 4.5]
        mols += [m, Molecule(m.symbols, [], coords=m.coords)]
    for m in mols:
        assert_same_scores(port, ref, m)
    assert port.score(mols[0]) > 1.0 > 0 > port.score(mols[1])


@pytest.mark.parametrize("directional", [True, False])
def test_pocket_terms_and_scores_equal_jax(dataset, tmp_path, directional):
    seen_hbond = False
    for i in PAIRS:
        pdb = pocket_pdb(dataset[i], tmp_path / f"p{i}.pdb")
        port, ref = ts.VinaScorer.from_pdb(pdb), js.VinaScorer.from_pdb(pdb)
        port.directional_hbond = ref.directional_hbond = directional
        assert_same_scorer(port, ref)
        for bonds in (True, False):
            m = ligand(dataset[i], bonds)
            assert_same_scores(port, ref, m)
            seen_hbond |= port.interaction_terms(m)["hbond"] > 0
        # a copy moved onto the nearest pocket atom (clashes)
        m = ligand(dataset[i])
        shifted = Molecule(m.symbols, m.bonds, coords=m.coords
                           + pair_offset(dataset[i]))
        assert_same_scores(port, ref, shifted)
    assert seen_hbond


def pair_offset(pair):
    """From the ligand centre to the nearest pocket atom."""
    c = pair.lig_coords.mean(0)
    d = np.linalg.norm(pair.pocket_coords - c, axis=1)
    return pair.pocket_coords[d.argmin()] - c


def test_residue_hbond_types_equal_jax():
    names = sorted({n for atoms in RESIDUES.values() for n in atoms.split()}
                   | {"OXT", "XX", "N1", "O1"})
    n = 0
    for resname in sorted(RESIDUES) + ["HOH", "UNK"]:
        for name in names:
            for el in ("N", "O", "C", "S", "H"):
                got = ts.residue_hbond_types(resname, name, el)
                assert got == js.residue_hbond_types(resname, name, el)
                n += any(got)
    assert n > 100


def test_from_pdb_with_and_without_protein_only(tmp_path, dataset):
    pdb = residue_pdb(tmp_path / "rec.pdb")
    names = sorted(RESIDUES)
    n_protein = sum(len(RESIDUES[names[r % len(names)]].split())
                    for r in range(27))
    m = ligand(dataset[220])
    m.coords = m.coords - m.coords.mean(0) + 6.0
    for protein_only in (True, False):
        port = ts.VinaScorer.from_pdb(pdb, protein_only=protein_only)
        ref = js.VinaScorer.from_pdb(pdb, protein_only=protein_only)
        assert_same_scorer(port, ref)
        assert_same_scores(port, ref, m)
        assert len(port.rec_x) == n_protein + 6 * (not protein_only)
    assert port.rec_donor.sum() > 20 and port.rec_acceptor.sum() > 20
    assert port.rec_hdir_has.mean() > 0.9


def test_vina_score_like_equals_jax(tmp_path, dataset):
    pdb = pocket_pdb(dataset[220], tmp_path / "p.pdb")
    mols = [ligand(dataset[220]), None, ligand(dataset[220], bonds=False)]
    got = ts.vina_score_like(mols, pdb)
    want = js.vina_score_like([None if m is None else to_jax(m)
                               for m in mols], pdb)
    assert np.isnan(got[1]) and np.isnan(want[1])
    assert got[0] == want[0] and got[2] == want[2] and got[0] < 0


def test_calibration_needs_smina(tmp_path, dataset, monkeypatch):
    from diffndm_tpu_torch.chem import docking

    monkeypatch.setenv("PATH", str(tmp_path))
    pdb = pocket_pdb(dataset[220], tmp_path / "p.pdb")
    with pytest.raises(docking.DockingUnavailable, match="smina"):
        ts.calibrate_against_smina(pdb, [])
    assert not docking.docking_available()


def symmetric_molecules():
    benzene = Molecule(["C"] * 6, [(i, (i + 1) % 6, 2 - i % 2)
                                   for i in range(6)])
    toluene = Molecule(["C"] * 7, benzene.bonds + [(0, 6, 1)])
    acetate = Molecule(["C", "C", "O", "O"], [(0, 1, 1), (1, 2, 2),
                                              (1, 3, 1)], charges=[0, 0, 0,
                                                                   -1])
    carboxyl = Molecule(["C", "C", "O", "O"], [(0, 1, 1), (1, 2, 1),
                                               (1, 3, 1)])
    tbutyl = Molecule(["C"] * 5 + ["N"], [(0, i, 1) for i in (1, 2, 3)]
                      + [(0, 4, 1), (4, 5, 1)])
    neopentane = Molecule(["C"] * 5, [(0, i, 1) for i in (1, 2, 3, 4)])
    return [benzene, toluene, acetate, carboxyl, tbutyl, neopentane]


def test_automorphisms_and_symmetry_rmsd_equal_jax(dataset):
    rng = np.random.default_rng(4)
    mols = symmetric_molecules() + [ligand(dataset[i]) for i in (0, 52)]
    counts = []
    for m in mols:
        jm = to_jax(m)
        perms = list(trmsd.graph_automorphisms(m))
        jperms = list(jrmsd.graph_automorphisms(jm))
        assert len(perms) == len(jperms)
        for p, q in zip(perms, jperms):
            np.testing.assert_array_equal(p, q)
        counts.append(len(perms))
        x = rng.normal(size=(m.n_atoms, 3))
        for y in (x[perms[-1]], x + rng.normal(size=x.shape) * 0.3):
            assert trmsd.symmetry_rmsd(m, x, y) == \
                jrmsd.symmetry_rmsd(jm, x, y)
        assert trmsd.symmetry_rmsd(m, x, x, max_autos=1) == 0.0
    # Kekule benzene keeps its 6 order-preserving symmetries; the charge
    # breaks acetate's
    assert counts[:6] == [6, 1, 1, 2, 6, 24]
    assert len(list(trmsd.graph_automorphisms(mols[5], max_count=5))) == 5


def oracle_batch(dataset):
    """16 rows around pocket 220: its ligand clean and perturbed, other
    test ligands moved into the pocket, and a noise row."""
    rng = np.random.default_rng(5)
    pair = dataset[220]
    c = pair.lig_coords.mean(0)
    items = [(pair.lig_coords + rng.normal(size=pair.lig_coords.shape) * s,
              pair.lig_one_hot.argmax(1)) for s in (0.0, 0.05, 0.2, 0.5)]
    for i in (0, 3, 7, 9, 17, 24, 29, 48, 52, 101, 150):
        p = dataset[i]
        items.append((p.lig_coords - p.lig_coords.mean(0) + c,
                      p.lig_one_hot.argmax(1)))
    items.append((rng.normal(size=(12, 3)) * 1.5 + c,
                  rng.integers(0, 10, size=12)))
    n = max(len(t) for _, t in items)
    coords = np.zeros((len(items), n, 3), np.float32)
    types = np.zeros((len(items), n), np.int64)
    mask = np.zeros((len(items), n), np.float32)
    for b, (x, t) in enumerate(items):
        coords[b, :len(t)], types[b, :len(t)], mask[b, :len(t)] = x, t, 1
    return coords, types, mask


@pytest.mark.parametrize("workers", [0, 4])
def test_oracle_vina_rewards_equal_jax(dataset, tmp_path, workers):
    coords, types, mask = oracle_batch(dataset)
    assert len(coords) == 16
    pdb = pocket_pdb(dataset[220], tmp_path / "p.pdb")
    weights = (2.0, 2.0, 0.2, 20.0, -1.0, 5.0, 0.1)
    ref = JaxOracle(jax_params["crossdock_full"], num_workers=0)
    ref.native = None
    ref.set_receptor(pdb)
    want = ref.score_batch_types(coords, types, mask, weights)
    plain = ref.score_batch_types(coords, types, mask, weights[:6])
    assert (want != plain).sum() > 10
    for scorer in ("python", "native"):
        oracle = RewardOracle(INFO, scorer=scorer, num_workers=workers)
        with oracle:
            oracle.set_receptor(pdb)
            got = oracle.score_batch_types(coords, types, mask, weights)
            # the affinity batch went through no worker process
            assert oracle._processes is None
            # w_vina 0 with the receptor set: the rewards do not change
            again = oracle.score_batch_types(coords, types, mask,
                                             weights[:6] + (0.0,))
            oracle.scorer = None
            before = oracle.score_batch_types(coords, types, mask,
                                              weights[:6])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(before, plain)
        np.testing.assert_array_equal(again, plain)
        assert oracle.n_scored == 3 * len(coords)


def test_oracle_set_receptor_takes_a_scorer(dataset, tmp_path):
    coords, types, mask = oracle_batch(dataset)
    pdb = pocket_pdb(dataset[220], tmp_path / "p.pdb")
    oracle = RewardOracle(INFO, scorer="python")
    oracle.set_receptor(ts.VinaScorer.from_pdb(pdb))
    from_path = RewardOracle(INFO, scorer="python")
    from_path.set_receptor(pdb)
    weights = (2.0, 3.0, 0.2, 0.0, 0.0, 0.0, 0.1)
    np.testing.assert_array_equal(
        oracle.score_batch_types(coords, types, mask, weights),
        from_path.score_batch_types(coords, types, mask, weights))
    # a nonzero w_vina without a receptor adds nothing
    bare = RewardOracle(INFO, scorer="python")
    np.testing.assert_array_equal(
        bare.score_batch_types(coords, types, mask, weights),
        bare.score_batch_types(coords, types, mask, weights[:6]))
