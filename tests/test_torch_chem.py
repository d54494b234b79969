"""The port's molecule building and SDF output against the JAX package's
on the same coordinates and types: real test ligands (aromatic rings,
so the kekulization matching is exercised) and the same ligands with
their coordinates perturbed the way generated point clouds are.  Bonds,
orders and the SDF text must be identical."""

import numpy as np
import pytest

pytest.importorskip("torch")

from diffndm_tpu.chem.bonds import build_molecules_batch as jax_build  # noqa: E402
from diffndm_tpu.chem.io import write_sdf as jax_write_sdf  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecules_batch  # noqa: E402
from diffndm_tpu_torch.chem.io import write_sdf  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402


def padded_ligands(noise, seed, n_mols=40):
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    pairs = [ds[i] for i in range(n_mols)]
    n = max(len(p.lig_coords) for p in pairs)
    rng = np.random.default_rng(seed)
    coords = np.zeros((n_mols, n, 3), np.float32)
    types = np.zeros((n_mols, n), np.int64)
    mask = np.zeros((n_mols, n), np.float32)
    for i, p in enumerate(pairs):
        k = len(p.lig_coords)
        coords[i, :k] = p.lig_coords + rng.normal(size=(k, 3)) * noise
        types[i, :k] = p.lig_one_hot.argmax(-1)
        mask[i, :k] = 1
    return coords, types, mask


@pytest.mark.parametrize("noise", [0.0, 0.15])
def test_molecules_and_sdf_match_jax(noise, tmp_path):
    coords, types, mask = padded_ligands(noise, seed=int(noise * 100))
    ours = build_molecules_batch(coords, types, mask,
                                 dataset_params["crossdock_full"])
    ref = jax_build(coords, types, mask, jax_params["crossdock_full"])
    assert len(ours) == len(ref)
    n_double = 0
    for a, b in zip(ours, ref):
        assert a.symbols == b.symbols
        assert a.bonds == b.bonds
        np.testing.assert_array_equal(a.coords, b.coords)
        assert a.fragments() == b.fragments()
        n_double += sum(o == 2 for _, _, o in a.bonds)
    assert n_double > 0  # the ring/multiple-bond stages were reached
    write_sdf(str(tmp_path / "port.sdf"), ours)
    jax_write_sdf(str(tmp_path / "jax.sdf"), ref)
    assert (tmp_path / "port.sdf").read_text() == \
        (tmp_path / "jax.sdf").read_text()


def test_empty_and_tiny_molecules():
    info = dataset_params["crossdock_full"]
    coords = np.zeros((2, 4, 3), np.float32)
    coords[1, 1] = [1.5, 0, 0]
    types = np.zeros((2, 4), np.int64)
    mask = np.zeros((2, 4), np.float32)
    mask[1, :2] = 1
    empty, pair = build_molecules_batch(coords, types, mask, info)
    assert empty.n_atoms == 0 and empty.bonds == []
    assert pair.symbols == ["C", "C"] and pair.bonds == [(0, 1, 1)]
