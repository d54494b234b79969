"""The entry points of the affinity slice on the CPU (``--device cpu``),
against the JAX package's where it has them:

- ``generate --w_vina`` on a tiny model: the receptor is the PDB pocket,
  and every guidance reward call carries the affinity weight and is
  scored in the calling process;
- ``optimize --objective vina`` for 2 generations of 4: the best score is
  the negated affinity of the best molecule written;
- ``evaluate --receptor`` (text ``==`` JAX's) and ``--receptor --dock``
  (JAX's draws fed to the port's search: the same text, the `` dock~=``
  number within 0.02 of JAX's);
- ``chem.docking`` ``--engine native`` writing its CSV, JSON and docked
  poses, and its parser (JAX's plus ``--device``);
- ``ChemistryDashboard(receptor_pdb=...)``: ``VinaAffinity`` and every
  other metric ``==`` the JAX dashboard's on the same batch.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import docking as jdocking  # noqa: E402
from diffndm_tpu.cli import evaluate as jevaluate  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxNodeBatch  # noqa: E402
from diffndm_tpu.train.eval_dashboard import \
    ChemistryDashboard as JaxDashboard  # noqa: E402
from diffndm_tpu_torch.chem import dock as td  # noqa: E402
from diffndm_tpu_torch.chem import docking  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.chem.scoring import VinaScorer  # noqa: E402
from diffndm_tpu_torch.cli import evaluate, generate, optimize  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.eval_dashboard import \
    ChemistryDashboard  # noqa: E402
from test_torch_cli import TINY  # noqa: E402
from test_torch_dock import jax_draws  # noqa: E402
from test_torch_scoring import pocket_pdb  # noqa: E402

INFO = dataset_params["crossdock_full"]
POCKET = 220
# test ligands of one bucket key, (16, 4, 64): one JAX compile
DOCKED = (0, 24, 9)
DOCK_ATOL = 0.02     # the dock~= value, printed to 0.01


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Test pocket 220 as PDB (one ALA per atom), its ligand with bonds as
    the reference SDF, three test ligands of one bucket key moved into the
    pocket as a second SDF, and the tiny config."""
    d = tmp_path_factory.mktemp("vina_cli")
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    pair = ds[POCKET]
    files = {n: str(d / n) for n in ("pocket.pdb", "ligand.sdf",
                                     "docked_in.sdf", "tiny.yml")}
    pocket_pdb(pair, d / "pocket.pdb")
    write_sdf(files["ligand.sdf"], [build_molecule(
        pair.lig_coords, pair.lig_one_hot.argmax(1), INFO)])
    centre = pair.lig_coords.mean(0)
    mols = []
    for i in DOCKED:
        m = build_molecule(ds[i].lig_coords, ds[i].lig_one_hot.argmax(1),
                           INFO)
        m.coords = m.coords - m.coords.mean(0) + centre
        mols.append(m)
    write_sdf(files["docked_in.sdf"], mols)
    with open(files["tiny.yml"], "w") as f:
        f.write(TINY)
    return dict(dir=d, pair=pair, **files)


def test_generate_with_w_vina_on_cpu(inputs, monkeypatch):
    calls = []
    original = RewardOracle.score_batch_types

    def recording(self, coords, types, mask, weights):
        out = original(self, coords, types, mask, weights)
        calls.append((weights, self.scorer, self._processes))
        return out

    monkeypatch.setattr(RewardOracle, "score_batch_types", recording)
    monkeypatch.setenv("DIFFNDM_ORACLE_WORKERS", "4")
    out = str(inputs["dir"] / "vina.sdf")
    model = generate.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["tiny.yml"],
        "--pdbfile", inputs["pocket.pdb"], "--ref_ligand",
        inputs["ligand.sdf"], "--outfile", out, "--n_samples", "4",
        "--SPSA", "1", "--SVDD", "1", "--w_vina", "0.1", "--seed", "1",
        "--device", "cpu"])
    scorer = model.oracle.scorer
    np.testing.assert_array_equal(
        scorer.rec_x, VinaScorer.from_pdb(inputs["pocket.pdb"]).rec_x)
    assert len(calls) > 2 and model.oracle.n_scored > 0
    # every guidance call carries the affinity weight, and none of them
    # went to a worker process
    assert all(w[6] == 0.1 and s is scorer and p is None
               for w, s, p in calls)
    assert os.path.exists(out)


def test_optimize_with_vina_objective_on_cpu(inputs):
    out = str(inputs["dir"] / "opt_vina.sdf")
    history = optimize.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["tiny.yml"],
        "--pdbfile", inputs["pocket.pdb"], "--ref_ligand",
        inputs["ligand.sdf"], "--outfile", out, "--objective", "vina",
        "--population_size", "4", "--evolution_steps", "2", "--top_k", "2",
        "--timesteps", "2", "--device", "cpu"])
    assert len(history) == 2
    best = read_sdf(out)
    scorer = VinaScorer.from_pdb(inputs["pocket.pdb"])
    if best:                 # the SDF holds coordinates to 1e-4 A
        assert np.isclose(history[-1]["best"], -scorer.score(best[0]),
                          rtol=0, atol=1e-2)
        assert np.isfinite(history[-1]["best"])
    else:                    # nothing sanitized: the -inf sentinel
        assert history[-1]["best"] == -np.inf


def jax_draw_poses(seed, lead, k, mc_rounds, box_size, device):
    """The port's draw_poses with JAX dock.py's key splits."""
    return jax_draws(seed, lead, k, mc_rounds, box_size / 2.0).to(device)


@pytest.mark.parametrize("dock", [False, True], ids=["rescore", "dock"])
def test_evaluate_receptor_report_equals_jax(inputs, tmp_path, monkeypatch,
                                             dock):
    flags = ["--receptor", inputs["pocket.pdb"]] + (
        ["--dock", "--dock_restarts", "4"] if dock else [])
    sdf = inputs["docked_in.sdf"]
    jevaluate.main([sdf, "--out", str(tmp_path / "jax.txt")] + flags)
    want = (tmp_path / "jax.txt").read_text().splitlines()
    monkeypatch.setattr(td, "draw_poses", jax_draw_poses)
    got = evaluate.main([sdf, "--device", "cpu"] + flags).splitlines()
    tag = " dock~=" if dock else " Vina~="
    assert len(got) == len(want) == 2 and tag in want[0]
    head, value = got[0].split(tag)
    jhead, jvalue = want[0].split(tag)
    assert head == jhead and got[1:] == want[1:]
    if dock:
        assert abs(float(value) - float(jvalue)) <= DOCK_ATOL
    else:
        assert value == jvalue


def test_docking_cli_native_engine(inputs, tmp_path):
    rec_dir, lig_dir, out = (tmp_path / n for n in ("rec", "lig", "out"))
    rec_dir.mkdir()
    lig_dir.mkdir()
    with open(inputs["pocket.pdb"]) as f:
        (rec_dir / "p220.pdb").write_text(f.read())
    mols = read_sdf(inputs["docked_in.sdf"])
    write_sdf(str(lig_dir / "p220_A_lig.sdf"), mols[:2])
    write_sdf(str(lig_dir / "nomatch_A_lig.sdf"), mols[2:])
    docking._main(["--pdbqt_dir", str(rec_dir), "--sdf_dir", str(lig_dir),
                   "--out_dir", str(out), "--write_csv", "--write_dict",
                   "--engine", "native", "--restarts", "2", "--device",
                   "cpu"])
    with open(out / "qvina2_scores.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["receptor", "ligand", "scores"] and len(rows) == 2
    with open(out / "qvina2_scores.json") as f:
        scores = json.load(f)
    assert list(scores) == ["p220_A_lig"]
    assert len(scores["p220_A_lig"]["scores"]) == 2
    assert np.isfinite(scores["p220_A_lig"]["scores"]).all()
    assert len(read_sdf(str(out / "p220_A_lig_docked.sdf"))) == 2


def test_docking_parser_is_jax_plus_device():
    import argparse

    parsers = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        parsers[len(parsers)] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        for main in (docking._main, jdocking._main):
            with pytest.raises(SystemExit):
                main([])
    finally:
        argparse.ArgumentParser.parse_args = real

    def actions(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices)
                for a in p._actions if a.dest != "help"}

    ours, ref = actions(parsers[0]), actions(parsers[1])
    assert ours.pop("device") == (["--device"], "cuda", str, None)
    assert ours == ref


def test_dashboard_receptor_affinity_equals_jax(inputs):
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    centre = inputs["pair"].lig_coords.mean(0)
    items = [ds[i] for i in (POCKET, 0, 3, 9, 24, 48)]
    n = max(len(p.lig_coords) for p in items)
    x = np.zeros((len(items), n, 3), np.float32)
    h = np.zeros((len(items), n, 10), np.float32)
    mask = np.zeros((len(items), n), np.float32)
    for b, p in enumerate(items):
        k = len(p.lig_coords)
        x[b, :k] = p.lig_coords - p.lig_coords.mean(0) + centre
        h[b, np.arange(k), p.lig_one_hot.argmax(1)] = 1.0
        mask[b, :k] = 1.0
    port = ChemistryDashboard(INFO, str(inputs["dir"]),
                              receptor_pdb=inputs["pocket.pdb"])
    ref = JaxDashboard(jax_params["crossdock_full"], str(inputs["dir"]),
                       receptor_pdb=inputs["pocket.pdb"])
    got = port.analyze(NodeBatch(*(torch.from_numpy(a)
                                   for a in (x, h, mask))))
    want = ref.analyze(JaxNodeBatch(x, h, mask))
    assert got == want and "VinaAffinity" in got
    assert np.isfinite(got["VinaAffinity"])
    assert "VinaAffinity" not in ChemistryDashboard(
        INFO, str(inputs["dir"])).analyze(NodeBatch(
            *(torch.from_numpy(a) for a in (x, h, mask))))
