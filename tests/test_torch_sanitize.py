"""The port's output filters against the JAX package's, molecule by
molecule: ``process_molecule`` under every combination of its switches
(sanitize, largest fragment, relax), ``relax`` alone, ``check_valences``
and ``filter_ring33``, on ~100 molecules built from the processed
virtual_v3 test ligands, clean and perturbed (so that some fail
sanitization or fall apart into fragments).  Filter outcomes, symbols and
bonds equal; relaxed coordinates within 1e-9 A (float64 steepest descent
in both).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import sanitize as jS  # noqa: E402
from diffndm_tpu.chem.bonds import build_molecule as jax_build  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu_torch.chem import sanitize as tS  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402

INFO, JINFO = dataset_params["crossdock_full"], jax_params["crossdock_full"]
ATOL = 1e-9


def molecule_pairs():
    """(port, JAX) molecules: 50 test ligands clean and the same 50 with
    0.25 A noise."""
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz",
                                      center=False)
    rng = np.random.default_rng(11)
    out = []
    for sigma in (0.0, 0.25):
        for i in range(0, 250, 5):
            pair = ds[i]
            coords = pair.lig_coords.astype(np.float64)
            coords = coords + rng.normal(size=coords.shape) * sigma
            types = pair.lig_one_hot.argmax(1)
            out.append((build_molecule(coords, types, INFO),
                        jax_build(coords, types, JINFO)))
    return out


PAIRS = molecule_pairs()


def same(out, ref, atol=ATOL):
    """Both filtered out, or the same molecule.  Returns whether it was
    kept."""
    if ref is None or out is None:
        assert out is None and ref is None
        return False
    assert out.symbols == ref.symbols and out.bonds == ref.bonds
    np.testing.assert_allclose(out.coords, ref.coords, rtol=0, atol=atol)
    return True


def test_the_set_has_failures_and_fragments():
    valid = [tS.is_valid(m) for m, _ in PAIRS]
    frags = [len(m.fragments()) for m, _ in PAIRS]
    assert len(PAIRS) == 100
    assert 0 < sum(valid) < len(PAIRS) and max(frags) > 1


@pytest.mark.parametrize("sanitize_flag", [False, True])
@pytest.mark.parametrize("largest_frag", [False, True])
@pytest.mark.parametrize("relax_iter", [0, 25])
def test_process_molecule_equals_jax(sanitize_flag, largest_frag,
                                     relax_iter):
    kept = 0
    for mol, jmol in PAIRS:
        out = tS.process_molecule(mol, sanitize_flag=sanitize_flag,
                                  relax_iter=relax_iter,
                                  largest_frag=largest_frag)
        ref = jS.process_molecule(jmol, sanitize_flag=sanitize_flag,
                                  relax_iter=relax_iter,
                                  largest_frag=largest_frag)
        kept += same(out, ref)
    assert (kept < len(PAIRS)) == sanitize_flag


def test_relax_equals_jax():
    moved = 0
    for mol, jmol in PAIRS[::3]:
        out, ref = tS.relax(mol, max_iter=200), jS.relax(jmol, max_iter=200)
        same(out, ref)
        moved += not np.array_equal(out.coords, mol.coords)
    assert moved > 0
    one = Molecule(["C"], [], coords=np.zeros((1, 3)))
    assert tS.relax(one) is one


def test_valence_and_ring33_filters_equal_jax():
    for mol, jmol in PAIRS:
        assert tS.check_valences(mol) == jS.check_valences(jmol)
        assert tS.filter_ring33(mol) == jS.filter_ring33(jmol)
    # two fused 3-rings share an atom: refused
    spiro = Molecule(["C"] * 5, [(0, 1, 1), (1, 2, 1), (2, 0, 1),
                                 (0, 3, 1), (3, 4, 1), (4, 0, 1)])
    assert not tS.filter_ring33(spiro)
    assert tS.filter_ring33(Molecule(["C"] * 3,
                                     [(0, 1, 1), (1, 2, 1), (2, 0, 1)]))
