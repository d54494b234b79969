"""The port's inpaint, fix_ligand and optimize CLIs and their helpers.

- ``Molecule.subgraph`` and ``fix_ligand.extract_fragment`` equal the JAX
  package's on test ligands of ``virtual_v3`` (bonds perceived by each
  package);
- ``substructure_coords_types`` (SDF mode, and PDB atom-name mode on a
  HETATM residue) and ``prepare_inpaint_ligand`` equal JAX's;
- the inpaint and optimize CLIs take the JAX CLIs' flags and defaults
  plus ``--device``, and run end to end on the CPU (a tiny random model,
  a few steps) writing their SDFs.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import bonds as jbonds  # noqa: E402
from diffndm_tpu.cli import fix_ligand as jfix  # noqa: E402
from diffndm_tpu.cli import inpaint as jinpaint  # noqa: E402
from diffndm_tpu.cli import optimize as joptimize  # noqa: E402
from diffndm_tpu.constants import \
    dataset_params as jdataset_params  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.cli import fix_ligand, inpaint, optimize  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402

DATA = "data/processed/virtual_v3/test.npz"
INFO = dataset_params["crossdock_full"]
DECODER = INFO["atom_decoder"]
TINY = """dataset: 'crossdock'
mode: 'pocket_conditioning'
pocket_representation: 'full-atom'
egnn_params:
  edge_cutoff_ligand: null
  edge_cutoff_pocket: 5.0
  edge_cutoff_interaction: 5.0
  joint_nf: 8
  hidden_nf: 16
  n_layers: 2
  attention: true
  tanh: true
  normalization_factor: 100
diffusion_params:
  diffusion_steps: 8
  diffusion_noise_schedule: 'polynomial_2'
  diffusion_noise_precision: 5.0e-4
  normalize_factors: [1, 4]
"""


def fake_model(info):
    """What the helpers read of a model."""
    return SimpleNamespace(dataset_info=info, cfg=SimpleNamespace(atom_nf=10),
                           sample_cfg=SimpleNamespace(lig_pad_multiple=8))


def ligand_of(pair):
    return pair.lig_coords.astype(np.float64), pair.lig_one_hot.argmax(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Test pocket 220 as a PDB (one ALA per pocket atom, then its ligand
    as HETATM residue LIG A:330 with atom names <element><index>), the
    ligand with perceived bonds as an SDF, its fragment, a tiny config."""
    d = tmp_path_factory.mktemp("inpaint_cli")
    pair = ProcessedLigandPocketDataset(DATA)[220]
    lines = []
    for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                    pair.pocket_one_hot)):
        el = DECODER[int(oh.argmax())].upper()
        lines.append(f"ATOM  {i + 1:>5} {el:<4} ALA A{i + 1:>4}    "
                     f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
    n0 = len(lines)
    coords, types = ligand_of(pair)
    names = []
    for i, (c, ty) in enumerate(zip(coords, types)):
        el = DECODER[int(ty)].upper()
        names.append(f"{el}{i + 1}")
        lines.append(f"HETATM{n0 + i + 1:>5} {names[-1]:<4} LIG A 330    "
                     f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
    files = {n: str(d / n) for n in ("pocket.pdb", "ligand.sdf", "tiny.yml")}
    with open(files["pocket.pdb"], "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    write_sdf(files["ligand.sdf"], [build_molecule(coords, types, INFO)])
    with open(files["tiny.yml"], "w") as f:
        f.write(TINY)
    frags = fix_ligand.main([str(d), "--outdir", str(d / "frags")])
    assert [os.path.basename(p) for p in frags] == ["ligand_frag.sdf"]
    return dict(dir=d, names=names, frag=frags[0], **files)


@pytest.mark.parametrize("index", [3, 48, 220, 7, 101])
@pytest.mark.parametrize("fraction", [0.25, 0.5])
def test_fragment_matches_jax(index, fraction):
    coords, types = ligand_of(ProcessedLigandPocketDataset(DATA)[index])
    mine = fix_ligand.extract_fragment(build_molecule(coords, types, INFO),
                                       fraction)
    theirs = jfix.extract_fragment(
        jbonds.build_molecule(coords, types, jdataset_params[
            "crossdock_full"]), fraction)
    assert mine.symbols == theirs.symbols
    assert mine.bonds == theirs.bonds
    np.testing.assert_array_equal(mine.coords, theirs.coords)
    assert mine.n_atoms <= max(1, int(len(coords) * fraction))
    assert len(mine.fragments()) == 1


def test_subgraph_matches_jax():
    coords, types = ligand_of(ProcessedLigandPocketDataset(DATA)[48])
    atoms = [0, 2, 3, 5, 8]
    mine = build_molecule(coords, types, INFO).subgraph(atoms)
    theirs = jbonds.build_molecule(
        coords, types, jdataset_params["crossdock_full"]).subgraph(atoms)
    assert (mine.symbols, mine.bonds) == (theirs.symbols, theirs.bonds)
    np.testing.assert_array_equal(mine.coords, theirs.coords)


@pytest.mark.parametrize("mode", ["sdf", "atom_names"])
def test_substructure_and_ligand_batch_match_jax(inputs, mode):
    if mode == "sdf":
        fix, kw = [inputs["frag"]], {}
        n_fixed = read_sdf(inputs["frag"])[0].n_atoms
    else:
        fix = inputs["names"][1:6:2]
        kw = dict(pdbfile=inputs["pocket.pdb"], ref_ligand="A:330")
        n_fixed = 3
    mine = inpaint.substructure_coords_types(fake_model(INFO), fix, **kw)
    theirs = jinpaint.substructure_coords_types(
        fake_model(jdataset_params["crossdock_full"]), fix, **kw)
    assert len(mine[0]) == n_fixed
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert mine[0].dtype == np.float32
    lig, fixed = inpaint.prepare_inpaint_ligand(fake_model(INFO), fix, 3, 5,
                                                **kw)
    jlig, jfixed = jinpaint.prepare_inpaint_ligand(
        fake_model(jdataset_params["crossdock_full"]), fix, 3, 5, **kw)
    for a, b in zip(list(lig) + [fixed], list(jlig) + [jfixed]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="needs --pdbfile"):
        inpaint.substructure_coords_types(fake_model(INFO), ["C1"])
    with pytest.raises(ValueError, match="not found"):
        inpaint.substructure_coords_types(fake_model(INFO), ["C1"],
                                          inputs["pocket.pdb"], "B:1")


def flags(parser):
    return {a.dest: (a.default, a.required, a.nargs, a.choices,
                     type(a).__name__) for a in parser._actions}


@pytest.mark.parametrize("ours, ref", [(inpaint, jinpaint),
                                       (optimize, joptimize)],
                         ids=["inpaint", "optimize"])
def test_parsers_match_jax_plus_device(ours, ref):
    mine = flags(ours.build_parser())
    assert mine.pop("device") == ("cuda", False, None, None, "_StoreAction")
    assert mine == flags(ref.build_parser())


def test_inpaint_cli_end_to_end_on_cpu(inputs):
    """ATP-guided at 3 steps x 2 resamplings (prunes at s = 2, 0): the
    fixed atoms come first in every molecule, written whole."""
    out = str(inputs["dir"] / "inpaint.sdf")
    frag = read_sdf(inputs["frag"])[0]
    res = inpaint.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["tiny.yml"],
        "--pdbfile", inputs["pocket.pdb"], "--outfile", out, "--fix_atoms",
        inputs["frag"], "--add_n_nodes", "3", "--n_samples", "3",
        "--timesteps", "3", "--resamplings", "2", "--svdd", "1", "--seed",
        "2", "--device", "cpu"])
    n = frag.n_atoms + 3
    assert res.ligand.x.shape[0] == 3
    np.testing.assert_array_equal(res.ligand.mask.sum(1).numpy(), [n] * 3)
    mols = read_sdf(out)
    assert len(mols) == 3 and all(m.n_atoms == n for m in mols)
    assert all(m.symbols[:frag.n_atoms] == frag.symbols for m in mols)
    # atom-name mode, the pocket around the HETATM residue
    res = inpaint.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["tiny.yml"],
        "--pdbfile", inputs["pocket.pdb"], "--outfile", out,
        "--ref_ligand", "A:330", "--fix_atoms", *inputs["names"][:2],
        "--add_n_nodes", "2", "--n_samples", "2", "--timesteps", "2",
        "--resamplings", "1", "--center", "pocket", "--device", "cpu"])
    np.testing.assert_array_equal(res.ligand.mask.sum(1).numpy(), [4, 4])
    assert len(read_sdf(out)) == 2


@pytest.mark.parametrize("objective", ["qed", "sa"])
def test_optimize_cli_end_to_end_on_cpu(inputs, objective):
    out = str(inputs["dir"] / f"opt_{objective}.sdf")
    history = optimize.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["tiny.yml"],
        "--pdbfile", inputs["pocket.pdb"], "--ref_ligand",
        inputs["ligand.sdf"], "--outfile", out, "--objective", objective,
        "--population_size", "4", "--evolution_steps", "2", "--top_k", "2",
        "--timesteps", "2", "--device", "cpu"])
    assert len(history) == 2
    assert all(0.0 <= h["mean"] <= h["best"] <= 1.0 for h in history)
    assert len(read_sdf(out)) <= 2
