"""The port's PDB entry against the JAX package's: ``parse_pdb``,
``get_pocket_from_ligand`` (SDF and ``<chain>:<resi>`` references),
``prepare_pocket`` (full-atom and CA) and ``read_sdf``, on a synthetic PDB
that holds every case the parser treats specially (alternate locations,
insertion codes, two MODELs, blank element columns with one- and
two-letter names, BR/CL, a HETATM ligand): equal exactly.  Then
``DiffNDM.pocket_from_pdb`` on a PDB written from a processed test pocket
equals ``pocket_from_dataset`` on the atoms within the cutoff.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem.io import read_sdf as jax_read_sdf  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.data import pdb as jpdb  # noqa: E402
from diffndm_tpu.data import pocket as jpocket  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.config import SampleConfig  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data import pdb as tpdb  # noqa: E402
from diffndm_tpu_torch.data import pocket as tpocket  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
DECODER = dataset_params["crossdock_full"]["atom_decoder"]


def record(rec, serial, name, resname, chain, resi, xyz, element="",
           altloc=" ", icode=" "):
    """One fixed-column ATOM/HETATM line; ``name`` is the 4-column atom
    name field as written."""
    x, y, z = xyz
    return (f"{rec:<6}{serial:>5} {name:<4}{altloc}{resname:>3} {chain}"
            f"{resi:>4}{icode}   {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
            f"          {element:>2}")


def write_synthetic_pdb(path):
    rng = np.random.default_rng(4)

    def xyz(center):
        return np.asarray(center) + rng.normal(size=3) * 0.8

    lines = ["HEADER    SYNTHETIC", "MODEL        1"]
    serial = 1
    residues = [("ALA", "A", 10, " "), ("GLY", "A", 11, " "),
                ("SER", "A", 11, "B"), ("HOH", "A", 12, " "),
                ("PHE", "B", 3, " "), ("TYR", "B", 40, " "),
                ("LYS", "A", 99, " ")]
    centers = [(0, 0, 0), (3, 1, 0), (4, -2, 1), (1, 3, 2), (-3, 2, 1),
               (-2, -3, 0), (30, 30, 30)]
    for (resname, chain, resi, icode), c in zip(residues, centers):
        for name, el in (("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O")):
            lines.append(record("ATOM", serial, f" {name}", resname, chain,
                                resi, xyz(c), el, icode=icode))
            serial += 1
    # alternate locations: A kept, B dropped; blank alt kept
    lines.append(record("ATOM", serial, " CB", "ALA", "A", 10, xyz((0, 1, 0)),
                        "C", altloc="A"))
    lines.append(record("ATOM", serial + 1, " CB", "ALA", "A", 10,
                        xyz((0, 1, 0)), "C", altloc="B"))
    # blank element columns: one letter from the name, a lower-case
    # second letter kept, an upper-case one dropped (BR1 reads as B),
    # digits stripped
    lines.append(record("ATOM", serial + 2, " SG", "SER", "A", 11,
                        xyz((4, -2, 1)), "", icode="B"))
    lines.append(record("ATOM", serial + 3, "Cl1 ", "PHE", "B", 3,
                        xyz((-3, 2, 1))))
    lines.append(record("ATOM", serial + 4, "BR1 ", "PHE", "B", 3,
                        xyz((-3, 2, 1))))
    lines.append(record("ATOM", serial + 5, " OH", "TYR", "B", 40,
                        xyz((-2, -3, 0)), "O"))
    # elements written in capitals
    lines.append(record("ATOM", serial + 6, "BR  ", "TYR", "B", 40,
                        xyz((-2, -3, 0)), "BR"))
    lines.append(record("ATOM", serial + 7, "CL  ", "TYR", "B", 40,
                        xyz((-2, -3, 0)), "CL"))
    lines.append(record("ATOM", serial + 8, " H1", "GLY", "A", 11,
                        xyz((3, 1, 0)), "H"))
    # the ligand, residue 330 of chain L
    for k in range(6):
        lines.append(record("HETATM", serial + 9 + k, f" C{k}", "LIG", "L",
                            330, xyz((0.5, 0.5, 0.5)), "C"))
    lines.append(record("HETATM", serial + 15, " O1", "HOH", "W", 330,
                        xyz((1, 1, 1)), "O"))
    lines += ["TER", "ENDMDL", "MODEL        2"]
    lines.append(record("ATOM", 900, " CA", "ALA", "A", 10, (9, 9, 9), "C"))
    lines += ["ENDMDL", "END"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_ligand_sdf(path, coords, symbols):
    write_sdf(path, [Molecule(list(symbols), [(0, 1, 1), (1, 2, 2)],
                              coords=np.asarray(coords, np.float64))])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pdb")
    pdb = str(d / "synthetic.pdb")
    write_synthetic_pdb(pdb)
    sdf = str(d / "ligand.sdf")
    write_ligand_sdf(sdf, [[0.2, 0.1, 0.4], [1.1, 0.9, 0.2], [0.0, 1.3, 1.0],
                           [-0.7, 0.4, 0.8]], ["C", "O", "N", "Cl"])
    return dict(pdb=pdb, sdf=sdf)


def residue_tuple(res):
    return (res.chain, res.resi, res.resname, res.icode,
            [(a.name, a.element, tuple(a.coord), a.is_hetero, a.altloc)
             for a in res.atoms])


@pytest.mark.parametrize("model", [1, 2, 3])
def test_parse_pdb_equals_jax(files, model):
    ref = jpdb.parse_pdb(files["pdb"], model=model)
    out = tpdb.parse_pdb(files["pdb"], model=model)
    assert [residue_tuple(r) for r in out.residues] == \
        [residue_tuple(r) for r in ref.residues]
    if model == 1:
        elements = [a.element for r in out.residues for a in r.atoms]
        assert {"S", "Cl", "B", "Br"} <= set(elements)
        assert len(out.residues) == 9       # SER 11B apart from GLY 11
        assert sorted(out.chains()) == sorted(ref.chains())
        assert residue_tuple(out.get_residue("L", 330)) == \
            residue_tuple(ref.get_residue("L", 330))
        with pytest.raises(ValueError):
            out.get_residue("A", 11)        # two residues: 11 and 11B
        res = out.residues[0]
        assert (res.is_standard_aa, res.one_letter) == ("ALA" in
                                                        jpdb.STANDARD_AA,
                                                        "A")
        assert res.ca.name == "CA"
    if model == 3:
        assert out.residues == []


def test_read_sdf_equals_jax(files, tmp_path):
    # a second record with an aromatic bond (order 4) and a leading blank
    path = str(tmp_path / "two.sdf")
    with open(files["sdf"]) as f:
        first = f.read()
    second = first.replace("  2  3  2", "  2  3  4").replace("mol_0", "")
    with open(path, "w") as f:
        f.write(first + "\n" + second)
    for p in (files["sdf"], path):
        ref, out = jax_read_sdf(p), read_sdf(p)
        assert len(out) == len(ref) >= 1
        for a, b in zip(out, ref):
            assert a.symbols == b.symbols and a.bonds == b.bonds
            np.testing.assert_array_equal(a.coords, b.coords)
    assert read_sdf(path)[1].bonds == [(0, 1, 1), (1, 2, 1)]


REFS = ["sdf", "L:330", "B:3"]


@pytest.mark.parametrize("ref", REFS)
@pytest.mark.parametrize("cutoff", [3.0, 8.0])
def test_get_pocket_from_ligand_equals_jax(files, ref, cutoff):
    ref_ligand = files["sdf"] if ref == "sdf" else ref
    jres = jpocket.get_pocket_from_ligand(jpdb.parse_pdb(files["pdb"]),
                                          ref_ligand, cutoff)
    tres = tpocket.get_pocket_from_ligand(tpdb.parse_pdb(files["pdb"]),
                                          ref_ligand, cutoff)
    assert [residue_tuple(r) for r in tres] == [residue_tuple(r) for r in jres]
    assert all(r.is_standard_aa for r in tres)
    if cutoff == 8.0:
        assert 0 < len(tres) < 8


@pytest.mark.parametrize("representation", ["full-atom", "CA"])
@pytest.mark.parametrize("drop_others", [False, True])
def test_prepare_pocket_equals_jax(files, representation, drop_others):
    if representation == "CA":
        encoder = dict(jax_params["crossdock"]["aa_encoder"])
    else:
        encoder = dict(dataset_params["crossdock_full"]["atom_encoder"])
        if drop_others:
            encoder = {k: v for k, v in encoder.items() if v < 10}
    residues = tpocket.get_pocket_from_ligand(tpdb.parse_pdb(files["pdb"]),
                                              "L:330", 8.0)
    jresidues = jpocket.get_pocket_from_ligand(jpdb.parse_pdb(files["pdb"]),
                                               "L:330", 8.0)
    out = tpocket.prepare_pocket(residues, encoder, representation,
                                 repeats=3, pad_multiple=16)
    ref = jpocket.prepare_pocket(jresidues, encoder, representation,
                                 repeats=3, pad_multiple=16)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out.x.shape[1] % 16 == 0


def write_pocket_pdb(path, pair):
    """One ALA residue per pocket atom, the element from the one-hot
    decoder (two-letter elements in capitals, as PDB files write them)."""
    lines = []
    for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                    pair.pocket_one_hot)):
        el = DECODER[int(oh.argmax())].upper()
        lines.append(record("ATOM", i + 1, el, "ALA", "A", i + 1, c, el))
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")


@pytest.mark.parametrize("index", [220, 3])
def test_pocket_from_pdb_equals_pocket_from_dataset(tmp_path, index):
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[index]
    pdb, sdf = str(tmp_path / "p.pdb"), str(tmp_path / "l.sdf")
    write_pocket_pdb(pdb, pair)
    write_sdf(sdf, [Molecule([DECODER[int(t)] for t in
                              pair.lig_one_hot.argmax(1)], [],
                             coords=pair.lig_coords.astype(np.float64))])
    model = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                              sample_cfg=SampleConfig(pocket_pad_multiple=16),
                              device="cpu")
    out = model.pocket_from_pdb(pdb, sdf, n_samples=2)
    d = np.linalg.norm(pair.pocket_coords[:, None]
                       - pair.lig_coords[None], axis=-1).min(1)
    keep = d < 8.0
    pair.pocket_coords = pair.pocket_coords[keep]
    pair.pocket_one_hot = pair.pocket_one_hot[keep]
    ref = model.pocket_from_dataset(pair, n_samples=2)
    assert out.x.shape == ref.x.shape
    np.testing.assert_array_equal(out.mask.numpy(), ref.mask.numpy())
    np.testing.assert_array_equal(out.h.numpy(), ref.h.numpy())
    # the PDB holds coordinates to 1e-3 A
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=5e-4 + 1e-6)
