"""The port's dataset pipeline against the JAX package's, on the same
files:

- ``chem/smiles.py``: every SMILES of tests/test_smiles_and_etl.py (its
  fuzz set included) and a few more parse to the same symbols, bonds with
  their orders, charges, implicit hydrogens, identity key and QED; the
  strings JAX refuses raise ``SmilesError`` in the port too;
- ``data/process_crossdock.py``: a CrossDocked tree of 8 pairs (three
  on the tiny receptor of tests/test_data.py, five written from
  virtual_v3's test split as chip_smoke.write_pocket_files writes them),
  processed by both with a fraction split and with a fixed-name split,
  full-atom and CA, whole and with ``train_subsample`` 0.5: every npz
  array ``array_equal``, ``size_distribution.npy`` within 1e-12,
  ``train_smiles.npy`` and ``summary.txt`` equal, the exported PDB, SDF
  and pocket-residue txt files byte-equal; ``load_split_file`` on .json
  and .pt; the CLIs of both on the same tree;
- ``data/prepare_crossdocked.py``: the same flat copy;
- ``data/process_bindingmoad.py``: a synthetic ``every.csv`` and two
  ``.bio1`` files with HETATM ligands: the label file, the QED filter, the
  EC split and the processed splits equal.

The JAX side's bond perception (train identity keys) runs on the native
library (tests/test_torch_jax_native.py).
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

import chip_smoke  # noqa: E402
from diffndm_tpu.chem import smiles as jsmiles  # noqa: E402
from diffndm_tpu.chem.properties import qed as jqed  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.data import prepare_crossdocked as jprep  # noqa: E402
from diffndm_tpu.data import process_bindingmoad as jmoad  # noqa: E402
from diffndm_tpu.data import process_crossdock as jcd  # noqa: E402
from diffndm_tpu_torch.chem import smiles as tsmiles  # noqa: E402
from diffndm_tpu_torch.chem.io import write_sdf  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.chem.properties import qed as tqed  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data import prepare_crossdocked as tprep  # noqa: E402
from diffndm_tpu_torch.data import process_bindingmoad as tmoad  # noqa: E402
from diffndm_tpu_torch.data import process_crossdock as tcd  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402

# ---------------------------------------------------------------------------
# SMILES
# ---------------------------------------------------------------------------

CORPUS = [
    "CCO", "C=C", "C#N", "CC(C)C", "C1CCCCC1", "C1CC2CCC1CC2", "c1ccccc1",
    "c1cc[nH]c1", "c1ccncc1", "c1ccc2ccccc2c1", "CC(=O)[O-]",
    "C[N+](C)(C)C", "[nH+]1ccccc1", "[N+].[Cl-]", "C%10CCCCC%10",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    # tests/test_smiles_and_etl.py::test_smiles_fuzz_roundtrip_stability
    "CC(C)NCC(O)c1ccc(O)c(O)c1", "CN1CCC[C@H]1c1cccnc1",
    "COc1ccc2cc(ccc2c1)C(C)C(=O)O",
    "Clc1ccccc1C2=NCC(=O)Nc3ccc(cc23)N(=O)=O",
    "CC(=O)Nc1nnc(s1)S(=O)(=O)N", "OC(=O)c1cc(O)c(O)c(O)c1",
    "c1ccc2c(c1)oc1ccccc12", "CN(C)CCOC(c1ccccc1)c1ccccc1",
    "O=C(O)CCCCCCCCC=C", "C1CC2(C1)CC2",
    # more of the grammar: isotopes, stereo bonds, explicit [H], ring-bond
    # symbols, five-membered heteroaromatics, charged nitro, halogens
    "[13CH3]C(=O)O", "C/C=C/C", "F/C=C\\F", "OC[H]", "C1=CC=CC=C1",
    "c1ccoc1", "c1ccsc1", "c1cn[nH]c1", "O=[N+]([O-])c1ccccc1",
    "BrC(Cl)(I)F", "c1ccc(cc1)P(=O)(O)O", "CS(=O)(=O)c1ccc(B(O)O)cc1",
    "C1CC1.C1CC1", "CC(C)(C)c1ccc2[nH]ccc2c1", "c1ccc2ncccc2c1",
]
BAD = ["C1CC", "C(", "C)", "Cc1cc1q", "", "not_a_smiles(((", "C%1CC",
       "[C", "c1cccc1", "[H]OC", ")C"]


def molecule_record(mol):
    return dict(symbols=list(mol.symbols),
                bonds=sorted((min(i, j), max(i, j), o)
                             for i, j, o in mol.bonds),
                charges=[mol.charge(i) for i in range(mol.n_atoms)],
                implicit_h=[mol.implicit_h(i) for i in range(mol.n_atoms)],
                key=mol.canonical_smiles_like())


@pytest.mark.parametrize("smi", CORPUS)
def test_smiles_parse_equals_jax(smi):
    ours, ref = tsmiles.parse_smiles(smi), jsmiles.parse_smiles(smi)
    assert molecule_record(ours) == molecule_record(ref)
    assert list(ours.bonds) == [tuple(b) for b in ref.bonds]
    assert tqed(ours) == jqed(ref)


@pytest.mark.parametrize("smi", BAD)
def test_smiles_errors_equal_jax(smi):
    with pytest.raises(jsmiles.SmilesError) as ref:
        jsmiles.parse_smiles(smi)
    with pytest.raises(tsmiles.SmilesError) as ours:
        tsmiles.parse_smiles(smi)
    assert str(ours.value) == str(ref.value)
    assert issubclass(tsmiles.SmilesError, ValueError)


# ---------------------------------------------------------------------------
# CrossDocked
# ---------------------------------------------------------------------------

TEST_POCKETS = (0, 5, 48, 220, 300)
TINY_OFFSETS = ((0.0, 0.0, 0.0), (2.0, 1.0, 0.0), (-1.5, 0.5, 1.0))


def write_tiny_pdb(path):
    """tests/test_data.py's receptor: ALA and GLY near the origin, SER far
    away."""
    res = [("ALA", 1, [("N", "N", (0, 0, 0)), ("CA", "C", (1.4, 0, 0)),
                       ("C", "C", (2.0, 1.3, 0)), ("O", "O", (1.5, 2.4, 0))]),
           ("GLY", 2, [("N", "N", (3.3, 1.3, 0)), ("CA", "C", (4.1, 2.5, 0)),
                       ("C", "C", (5.5, 2.2, 0)), ("O", "O", (6.0, 1.1, 0))]),
           ("SER", 3, [("N", "N", (30, 30, 30)), ("CA", "C", (31, 30, 30)),
                       ("C", "C", (32, 31, 30)), ("O", "O", (33, 32, 30))])]
    lines, serial = [], 1
    for resname, resi, atoms in res:
        for name, el, (x, y, z) in atoms:
            lines.append(
                f"ATOM  {serial:>5} {name:<4}{resname:>4} A{resi:>4}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          {el:>2}")
            serial += 1
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")


def write_tiny_sdf(path, offset):
    coords = np.array([[1.0, 1.0, 0.5], [2.4, 1.2, 0.5], [3.2, 2.3, 0.5]])
    write_sdf(path, [Molecule(["C", "C", "O"], [(0, 1, 1), (1, 2, 1)],
                              coords=coords + np.asarray(offset))])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """<base>/crossdocked_pocket10/<dir>/<rec>.pdb + <lig>.sdf for 8 pairs;
    returns (base, [(dir/rec.pdb, dir/lig.sdf)])."""
    base = tmp_path_factory.mktemp("crossdock")
    root = base / "crossdocked_pocket10"
    rel = []
    for k, offset in enumerate(TINY_OFFSETS):
        d = root / f"TINY{k}_HUMAN_1_100_0"
        d.mkdir(parents=True)
        write_tiny_pdb(str(d / f"1abc_A_rec_{k}.pdb"))
        write_tiny_sdf(str(d / f"1abc_A_rec_{k}_lig_tt_min_0.sdf"), offset)
        rel.append((f"{d.name}/1abc_A_rec_{k}.pdb",
                    f"{d.name}/1abc_A_rec_{k}_lig_tt_min_0.sdf"))
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz",
                                      center=False)
    decoder = dataset_params["crossdock_full"]["atom_decoder"]
    for i in TEST_POCKETS:
        d = root / f"V3_{i:03d}"
        d.mkdir()
        names = (f"v{i}_B_rec.pdb", f"v{i}_B_rec_lig_{i}.sdf")
        chip_smoke.write_pocket_files(ds[i], decoder, str(d), names=names)
        rel.append(tuple(f"{d.name}/{n}" for n in names))
    return base, rel


def tree_bytes(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def assert_outputs_equal(ours, ref):
    files, ref_files = tree_bytes(ours), tree_bytes(ref)
    assert sorted(files) == sorted(ref_files)
    for name, data in ref_files.items():
        if name.endswith(".npz"):
            with np.load(os.path.join(ours, name)) as a, \
                    np.load(os.path.join(ref, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in b.files:
                    assert a[k].dtype == b[k].dtype, (name, k)
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{name}:{k}")
        elif name == "size_distribution.npy":
            np.testing.assert_allclose(np.load(os.path.join(ours, name)),
                                       np.load(os.path.join(ref, name)),
                                       rtol=0, atol=1e-12)
        elif name == "train_smiles.npy":
            np.testing.assert_array_equal(np.load(os.path.join(ours, name)),
                                          np.load(os.path.join(ref, name)))
        else:
            assert files[name] == data, name
    return files


@pytest.mark.parametrize("subsample", [1.0, 0.5])
@pytest.mark.parametrize("ca_only", [False, True])
@pytest.mark.parametrize("named", [False, True])
def test_process_dataset_equals_jax(tree, tmp_path, named, ca_only,
                                    subsample):
    base, rel = tree
    basedir = str(base / "crossdocked_pocket10")
    key = "crossdock" if ca_only else "crossdock_full"
    outs = {}
    for label, mod, params in (("port", tcd, dataset_params),
                               ("jax", jcd, jax_params)):
        di = params[key]
        pocket_enc = di["aa_encoder"] if ca_only else di["atom_encoder"]
        kw = dict(dist_cutoff=8.0, ca_only=ca_only,
                  train_subsample=subsample, seed=3, dataset_info=di)
        if named:
            kw.update(split_names={"train": rel[1:6], "test": rel[6:] +
                                   rel[:1]},
                      basedir=basedir, val_from_train=2)
            pairs = None
        else:
            pairs = [(os.path.join(basedir, p), os.path.join(basedir, s))
                     for p, s in rel]
        outdir = str(tmp_path / label)
        res = mod.process_dataset(pairs, outdir, di["atom_encoder"],
                                  pocket_enc, **kw)
        outs[label] = (outdir, res)
    files = assert_outputs_equal(outs["port"][0], outs["jax"][0])
    ours, ref = outs["port"][1], outs["jax"][1]
    np.testing.assert_allclose(ours.histogram, ref.histogram, rtol=0,
                               atol=1e-12)
    assert (ours.atom_hist, ours.aa_hist) == (ref.atom_hist, ref.aa_hist)
    assert "train.npz" in files and "train_smiles.npy" in files
    if named and not ca_only:
        assert any(f.startswith("test/") and f.endswith(".txt")
                   for f in files)
        assert any(f.startswith("val/") for f in files)


def test_pocket_residue_ids_and_ligand_pair_equal_jax(tree):
    base, rel = tree
    root = base / "crossdocked_pocket10"
    enc = dataset_params["crossdock_full"]["atom_encoder"]
    for pdb, sdf in rel:
        pdb, sdf = str(root / pdb), str(root / sdf)
        ours = tcd.process_ligand_and_pocket(pdb, sdf, enc, enc)
        ref = jcd.process_ligand_and_pocket(pdb, sdf, enc, enc)
        for a, b in zip((ours.lig_coords, ours.lig_one_hot,
                         ours.pocket_coords, ours.pocket_one_hot),
                        (ref.lig_coords, ref.lig_one_hot, ref.pocket_coords,
                         ref.pocket_one_hot)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert ours.name == ref.name
        assert tcd.pocket_residue_ids(pdb, ours.lig_coords) == \
            jcd.pocket_residue_ids(pdb, ref.lig_coords)
        for cut in (3.0, 4.5, 6.0):
            assert tcd.pocket_residue_ids(pdb, ours.lig_coords, cut) == \
                jcd.pocket_residue_ids(pdb, ref.lig_coords, cut)


def test_cutoff_is_strict_and_in_float64(tmp_path):
    """A ligand atom 8 A from GLY's O (in float64, from its float32
    coordinates): GLY is out at a cutoff of 8 and in just above it, in both
    packages."""
    pdb, sdf = str(tmp_path / "r.pdb"), str(tmp_path / "l.sdf")
    write_tiny_pdb(pdb)
    write_sdf(sdf, [Molecule(["C", "C"], [(0, 1, 1)], coords=np.array(
        [[6.0, 1.1, 8.0], [6.0, 1.1, 9.4]]))])
    enc = dataset_params["crossdock_full"]["atom_encoder"]
    lig = np.array([[6.0, 1.1, 8.0]], np.float32)
    for mod in (tcd, jcd):
        assert mod.process_ligand_and_pocket(pdb, sdf, enc, enc) is None
        pair = mod.process_ligand_and_pocket(pdb, sdf, enc, enc,
                                             dist_cutoff=8.0 + 1e-6)
        assert len(pair.pocket_coords) == 4
        assert mod.pocket_residue_ids(pdb, lig, 8.0) == []
        assert mod.pocket_residue_ids(pdb, lig, 8.0 + 1e-6) == ["A:2"]


def test_load_split_file_json_and_pt(tmp_path):
    split = {"train": [("a/r.pdb", "a/l.sdf"), ("b/r.pdb", "b/l.sdf")],
             "test": [("c/r.pdb", "c/l.sdf")]}
    js = tmp_path / "split.json"
    js.write_text(json.dumps(split))
    pt = tmp_path / "split_by_name.pt"
    torch.save(split, pt)
    for path in (str(js), str(pt)):
        assert tcd.load_split_file(path) == jcd.load_split_file(path) == \
            split


def test_process_crossdock_clis_equal_jax(tree, tmp_path):
    base, rel = tree
    split = {"train": [list(p) for p in rel[:5]],
             "test": [list(p) for p in rel[5:]]}
    torch.save({k: [tuple(x) for x in v] for k, v in split.items()},
               base / "split_by_name.pt")
    for ca in ([], ["--ca_only"]):
        outs = []
        for mod, label in ((tcd, "port"), (jcd, "jax")):
            out = str(tmp_path / f"{label}{len(ca)}")
            mod.main([str(base), "--outdir", out, "--random_seed", "7",
                      "--train_subsample", "0.8", *ca])
            outs.append(out)
        assert_outputs_equal(*outs)
    (base / "split_by_name.pt").unlink()


def test_prepare_crossdocked_equals_jax(tree, tmp_path, capsys):
    base, rel = tree
    outs = []
    for mod, label in ((tprep, "port"), (jprep, "jax")):
        out = str(tmp_path / label)
        mod.main([str(base), "--outdir", out])
        outs.append(out)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace(outs[0], "OUT") == \
        printed[1].replace(outs[1], "OUT")
    files = assert_outputs_equal(*outs)
    assert len(files) == 2 * len(rel)
    keep = [os.path.basename(s)[:-4] for _, s in rel[:4]]
    for mod, label in ((tprep, "port_cut"), (jprep, "jax_cut")):
        assert mod.prepare_crossdocked(
            str(base), str(tmp_path / label), split_test_names=keep) == 4
    assert_outputs_equal(str(tmp_path / "port_cut"),
                         str(tmp_path / "jax_cut"))
    # a directory that is not a crossdocked_pocket10 tree is walked as is
    flat = tmp_path / "flat_in"
    shutil.copytree(base / "crossdocked_pocket10" / "V3_220", flat)
    for mod, label in ((tprep, "port_flat"), (jprep, "jax_flat")):
        assert mod.prepare_crossdocked(str(flat),
                                       str(tmp_path / label)) == 1
    assert_outputs_equal(str(tmp_path / "port_flat"),
                         str(tmp_path / "jax_flat"))


# ---------------------------------------------------------------------------
# Binding MOAD
# ---------------------------------------------------------------------------

# every.csv rows: class/EC rows (column 0), PDB rows (column 2), ligand
# rows (column 3 name, 4 validity, 9 SMILES)
EVERY_CSV = """\
1.1.1.1,,,,,,,,,
,,1ABC,,,,,,,
,,,LIG:A:501,valid,,,,,Cn1cnc2c1c(=O)n(C)c(=O)n2C
,,,HOH:A:900,invalid,,,,,O
2.7.11.1,,,,,,,,,
,,2XYZ,,,,,,,
,,,APC:B:601,valid,,,,,CC(=O)Nc1ccc(O)cc1
,,,ETH:B:602,valid,,,,,CCO
,,,BAD:B:603,valid,,,,,not_a_smiles(((
3.4.21.4,,,,,,,,,
,,3NOF,,,,,,,
,,,LIG:C:1,valid,,,,,COc1ccc2cc(ccc2c1)C(C)C(=O)O
"""


def write_bio1(path, ligand, resname, chain, resi, seed):
    """A receptor of 14 residues (N, CA, C, O, CB) scattered around a
    HETATM ligand, and a water."""
    rng = np.random.default_rng(seed)
    names = ("ALA", "SER", "GLY", "LEU", "CYS", "MET", "THR")
    lines, serial = [], 1
    for r in range(14):
        centre = ligand.mean(0) + rng.normal(size=3) * 6.0
        for name in ("N", "CA", "C", "O", "CB"):
            x, y, z = centre + rng.normal(size=3) * 0.9
            el = "S" if name == "CB" and names[r % 7] == "CYS" else name[0]
            lines.append(pdb_line("ATOM", serial, name,
                                         names[r % 7], "A", r + 1,
                                         (x, y, z), el))
            serial += 1
    for k, (c, el) in enumerate(ligand_atoms(ligand)):
        lines.append(pdb_line("HETATM", serial, f"{el}{k + 1}",
                                     resname, chain, resi, c, el))
        serial += 1
    lines.append(pdb_line("HETATM", serial, "O", "HOH", "A", 900,
                                 ligand.mean(0) + 9.0, "O"))
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")


def ligand_atoms(coords):
    els = ("C", "N", "C", "O", "C", "S", "C", "Cl")
    return [(c, els[k % len(els)]) for k, c in enumerate(coords)]


def pdb_line(rec, serial, name, resname, chain, resi, xyz, el):
    x, y, z = xyz
    return (f"{rec:<6s}{serial:5d} {name:<4s} {resname:>3s} {chain}"
            f"{resi:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
            f"          {el:>2s}")


@pytest.fixture(scope="module")
def moad(tmp_path_factory):
    base = tmp_path_factory.mktemp("moad")
    csv = base / "every.csv"
    csv.write_text(EVERY_CSV)
    data = base / "BindingMOAD_2020"
    data.mkdir()
    rng = np.random.default_rng(5)
    write_bio1(str(data / "1abc.bio1"), rng.normal(size=(7, 3)) * 1.5,
               "LIG", "A", 501, 1)
    write_bio1(str(data / "2xyz.bio1"), rng.normal(size=(9, 3)) * 1.5 + 20,
               "APC", "B", 601, 2)
    return str(data), str(csv)


def test_moad_label_file_filter_and_split_equal_jax(moad):
    _, csv = moad
    labels = tmoad.read_label_file(csv)
    assert labels == jmoad.read_label_file(csv)
    assert sorted(labels) == ["1abc", "2xyz", "3nof"]
    with pytest.warns(UserWarning, match="could not score"):
        scored = tmoad.compute_druglikeness(labels)
    with pytest.warns(UserWarning, match="could not score"):
        ref = jmoad.compute_druglikeness(labels)
    assert scored == ref
    for kw in (dict(qed_thresh=0.3, max_occurrences=50),
               dict(qed_thresh=0.0), dict(qed_thresh=0.5, seed=4),
               dict(max_occurrences=1, val_fraction=0.3, test_fraction=0.3)):
        assert tmoad.filter_and_split(scored, **kw) == \
            jmoad.filter_and_split(scored, **kw)


@pytest.mark.parametrize("ca_only", [False, True])
def test_process_bindingmoad_equals_jax(moad, tmp_path, ca_only):
    data, csv = moad
    out = {}
    for mod, label in ((tmoad, "port"), (jmoad, "jax")):
        with pytest.warns(UserWarning):
            out[label] = mod.process_bindingmoad(
                data, csv, str(tmp_path / label), ca_only=ca_only)
    assert_outputs_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    ours, ref = out["port"], out["jax"]
    assert sorted(ours) == sorted(ref)
    n = 0
    for split in ref:
        assert [p.name for p in ours[split]] == [p.name for p in ref[split]]
        for a, b in zip(ours[split], ref[split]):
            for k in ("lig_coords", "lig_one_hot", "pocket_coords",
                      "pocket_one_hot"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            n += 1
    assert n == 2        # the two ligands with files and QED above 0.3
