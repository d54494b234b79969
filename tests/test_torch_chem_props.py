"""The port's host chemistry against the JAX package's, molecule by
molecule, with exact equality: the guidance rewards are built on these
floats and a last-bit difference can flip a candidate selection.

Molecule sets: hand-built molecules and noisy variants of them (the
guidance-time distribution: partly invalid), ligands of the processed
virtual_v3 test set clean and perturbed, and random point clouds.  Every
comparison is ``==`` on Python floats / ints; none needs an ulp of slack.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import descriptors as jD  # noqa: E402
from diffndm_tpu.chem import morgan as jM  # noqa: E402
from diffndm_tpu.chem import properties as jP  # noqa: E402
from diffndm_tpu.chem import sanitize as jS  # noqa: E402
from diffndm_tpu.chem.bonds import build_molecule as jax_build  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu_torch.chem import descriptors as tD  # noqa: E402
from diffndm_tpu_torch.chem import morgan as tM  # noqa: E402
from diffndm_tpu_torch.chem import properties as tP  # noqa: E402
from diffndm_tpu_torch.chem import sanitize as tS  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.metrics import MoleculeProperties  # noqa: E402
from diffndm_tpu_torch.chem.rings import find_rings  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402

INFO, JINFO = dataset_params["crossdock_full"], jax_params["crossdock_full"]
C, N, O = (INFO["atom_encoder"][s] for s in "CNO")


def hexagon(r=1.39):
    theta = np.linspace(0, 2 * np.pi, 7)[:6]
    return np.stack([r * np.cos(theta), r * np.sin(theta), np.zeros(6)], -1)


def hand_built():
    chain = np.stack([np.arange(5) * 1.52, np.zeros(5), np.zeros(5)], -1)
    phenol = np.vstack([hexagon(), hexagon()[0] * (2.75 / 1.39)])
    return [(hexagon(), np.full(6, C)),
            (chain, np.array([C, C, O, C, N])),
            (hexagon(), np.array([N, C, C, C, C, C])),
            (phenol, np.array([C] * 6 + [O])),
            (np.array([[0, 0, 0], [1.54, 0, 0], [2.3, 1.2, 0]]),
             np.array([C, C, O]))]


def dataset_ligands(lo, hi):
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    return [(ds[i].lig_coords.astype(np.float64),
             ds[i].lig_one_hot.argmax(-1)) for i in range(lo, hi)]


def noisy(items, sigma, seed):
    rng = np.random.default_rng(seed)
    return [(c + rng.normal(size=c.shape) * sigma, t) for c, t in items]


def point_clouds(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n, 3)) * 1.5,
             rng.integers(0, 10, size=n)) for n in (4, 9, 17, 26)
            for _ in range(8)]


SETS = {
    "hand_built": lambda: hand_built(),
    "hand_built_noise_0.1": lambda: noisy(hand_built() * 4, 0.1, 0),
    "hand_built_noise_0.4": lambda: noisy(hand_built() * 4, 0.4, 1),
    "ligands_0_60": lambda: dataset_ligands(0, 60),
    "ligands_60_120_noise_0.15": lambda: noisy(dataset_ligands(60, 120),
                                               0.15, 2),
    "ligands_120_180_noise_0.4": lambda: noisy(dataset_ligands(120, 180),
                                               0.4, 3),
    "ligands_180_240_noise_0.8": lambda: noisy(dataset_ligands(180, 240),
                                               0.8, 4),
    "point_clouds": lambda: point_clouds(5),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_properties_equal_jax(name):
    n_valid = 0
    for coords, types in SETS[name]():
        ours = build_molecule(coords, types, INFO)
        ref = jax_build(coords, types, JINFO)
        assert ours.bonds == ref.bonds
        assert ours.rings == ref.rings
        assert tS.is_valid(ours) == jS.is_valid(ref)
        assert tS.connectivity_fraction(ours) == \
            jS.connectivity_fraction(ref)
        # the evaluation protocol scores the largest fragment
        ours, ref = tS.largest_fragment(ours), jS.largest_fragment(ref)
        assert ours.symbols == ref.symbols and ours.bonds == ref.bonds
        valid = tS.is_valid(ours)
        assert valid == jS.is_valid(ref)
        if not valid:
            with pytest.raises(tS.SanitizeError):
                tS.sanitize(ours)
            continue
        n_valid += 1
        assert tM.morgan_counts(ours, 2) == jM.morgan_counts(ref, 2)
        assert tP.qed_properties(ours) == jP.qed_properties(ref)
        assert tP.qed(ours) == jP.qed(ref)
        assert tP.sa_score_raw(ours) == jP.sa_score_raw(ref)
        assert tP.sa_score(ours) == jP.sa_score(ref)
        assert tP.logp(ours) == jP.logp(ref)
        for walrus in (True, False):
            assert tP.lipinski_count(ours, walrus) == \
                jP.lipinski_count(ref, walrus)
        assert tD.structural_alerts(ours) == jD.structural_alerts(ref)
        props = MoleculeProperties()
        assert props.calculate_qed(ours) == jP.qed(ref)
        assert props.calculate_lipinski(ours) == jP.lipinski_count(ref)
    assert n_valid >= (1 if name == "point_clouds" else 3)


@pytest.mark.parametrize("which, logp, tpsa, hbd, hba", [
    (0, 1.687, 0.0, 0, 0),        # benzene (RDKit MolLogP 1.6866)
    (2, 1.08, 12.89, 0, 1),       # pyridine
    (3, 1.392, 20.23, 1, 1),      # phenol
    (4, -0.0014, 20.23, 1, 1),    # ethanol
])
def test_descriptor_anchors(which, logp, tpsa, hbd, hba):
    mol = build_molecule(*hand_built()[which], INFO)
    assert tS.is_valid(mol)
    assert abs(tD.crippen_logp(mol) - logp) < 0.02
    assert abs(tD.tpsa(mol) - tpsa) < 0.01
    assert (tD.num_hbd(mol), tD.num_hba(mol)) == (hbd, hba)


def test_fragment_table_is_the_ports_own_copy():
    """The SA fragment table is read from the port's assets and holds the
    same bits and scores as the JAX package's."""
    import os

    bits, scores = tP.load_fpscores()
    assert os.path.dirname(tP.FPSCORES).endswith(
        os.path.join("diffndm_tpu_torch", "assets"))
    jbits, jscores = jP._load_fpscores()
    np.testing.assert_array_equal(bits, jbits)
    np.testing.assert_array_equal(scores, jscores)


def test_rings_follow_bond_order_on_fused_systems():
    """Two triangles sharing an edge with a pendant third: which small
    rings are kept depends on the neighbour order, which must be the
    bonds' own (as native/chemgraph.cpp keeps it), not a set's.  Pinned
    on the graph of test ligand 48, whose ring list once differed."""
    from diffndm_tpu.chem import native as jnative

    pair = dataset_ligands(48, 49)[0]
    mol = build_molecule(*pair, INFO)
    edges = [(i, j) for i, j, _ in mol.bonds]
    ours = find_rings(mol.n_atoms, edges)
    assert sorted(len(r) for r in ours) == [3, 3, 6, 7]
    if jnative.available():
        assert ours == jnative.find_rings_native(mol.n_atoms, edges)


def test_quality_summary_follows_the_evaluation_protocol():
    """The summary of a mixed population (valid, invalid, fragmented)
    equals the JAX package's evaluation arithmetic on the same molecules
    (scripts/guided_lift_eval.py: largest fragment scored, validity = it
    sanitizes, connectivity over all molecules)."""
    from diffndm_tpu_torch.chem.metrics import quality_summary

    items = (dataset_ligands(0, 20) + noisy(dataset_ligands(20, 50), 0.5, 9)
             + point_clouds(6))
    out = quality_summary([build_molecule(c, t, INFO) for c, t in items])
    rows, conn = [], []
    for c, t in items:
        mol = jax_build(c, t, JINFO)
        conn.append(jS.connectivity_fraction(mol))
        frag = jS.largest_fragment(mol)
        if jS.is_valid(frag):
            rows.append((jP.qed(frag), jP.sa_score(frag), jP.logp(frag),
                         jP.lipinski_count(frag)))
    arr = np.asarray(rows, float)
    assert out["n"] == len(items) and 0 < len(rows) < len(items)
    assert out["valid"] == len(rows) / len(items)
    assert out["connectivity"] == float(np.mean(conn))
    assert out["connected"] == float(np.mean([c >= 1.0 for c in conn]))
    assert 0 < out["connected"] < 1
    for i, k in enumerate(("qed", "sa", "logp", "lipinski")):
        assert out[k] == float(arr[:, i].mean())
    empty = quality_summary([])
    assert empty["n"] == 0 and empty["valid"] == 0.0 and empty["qed"] == 0.0
