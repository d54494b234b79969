"""The port's test-set sweep (``cli.sweep``) on the CPU: the JAX sweep's
flags and defaults plus ``--device``; the three modes end to end on a
tiny model over test pockets written as PDB + SDF pairs (per pocket with
oversampling, ``--batch_pockets`` with ATP, ``--inpaint`` with ATP), the
output names and the three ``pocket_times.txt`` formats of the JAX sweep,
``--resume`` in every mode; a pocket without an SDF and an unreadable PDB
skipped or retried as the JAX sweep does; a ``RuntimeError`` raised in
generation (a kernel's error) stops the sweep; and ``cli.evaluate`` over
a sweep's output.
"""

import argparse
import os
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.cli import sweep as jsweep  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.cli import evaluate, sweep  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from test_torch_cli import TINY  # noqa: E402

INFO = dataset_params["crossdock_full"]
POCKETS = {"p048": 48, "p220": 220, "p005": 5}


@pytest.fixture(scope="module")
def test_dir(tmp_path_factory):
    """<name>.pdb (one ALA per pocket atom) + <name>.sdf (the ligand with
    perceived bonds) for three test pockets, and the tiny config."""
    d = tmp_path_factory.mktemp("sweep")
    pockets = d / "pockets"
    pockets.mkdir()
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    for name, idx in POCKETS.items():
        pair = ds[idx]
        lines = []
        for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                        pair.pocket_one_hot)):
            el = INFO["atom_decoder"][int(oh.argmax())].upper()
            lines.append(f"ATOM  {i + 1:>5} {el:<4} ALA A{i + 1:>4}    "
                         f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
                         f"          {el:>2}")
        (pockets / f"{name}.pdb").write_text("\n".join(lines + ["END"])
                                             + "\n")
        write_sdf(str(pockets / f"{name}.sdf"), [build_molecule(
            pair.lig_coords, pair.lig_one_hot.argmax(1), INFO)])
    (d / "tiny.yml").write_text(TINY)
    return d


def run(test_dir, outdir, *flags, pockets="pockets"):
    return sweep.main(["missing.npz", "--config", str(test_dir / "tiny.yml"),
                       "--test_dir", str(test_dir / pockets), "--outdir",
                       str(outdir), "--n_samples", "2", "--timesteps", "4",
                       "--device", "cpu", *flags])


def times_lines(outdir):
    return (outdir / "pocket_times.txt").read_text().splitlines()


def jax_parser():
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jsweep.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


def actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.required, a.const, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_plus_device():
    mine, ref = actions(sweep.build_parser()), actions(jax_parser())
    assert mine.pop("device") == (("--device",), "cuda", str, None, False,
                                  None, None)
    assert mine == ref


def test_per_pocket_mode_and_resume(test_dir, tmp_path, capsys):
    out = tmp_path / "per_pocket"
    summary = run(test_dir, out, "--max_pockets", "2",
                  "--oversample_maxiter", "2", "--sanitize")
    assert summary == dict(written=2, resumed=0, skipped=0, retries=0,
                           generations=summary["generations"])
    assert 2 <= summary["generations"] <= 4
    assert sorted(os.listdir(out)) == ["p005_gen.sdf", "p048_gen.sdf",
                                       "pocket_times.txt"]
    lines = times_lines(out)
    assert [line.split()[0] for line in lines] == ["p005.pdb", "p048.pdb",
                                                   "mean"]
    assert all(re.fullmatch(r"\S+ \d+\.\d\d", line) for line in lines)
    for name in ("p005", "p048"):
        assert 1 <= len(read_sdf(str(out / f"{name}_gen.sdf"))) <= 2
    assert "sweep: 2 pockets written, 0 resumed, 0 skipped, 0 retries" in \
        capsys.readouterr().out
    again = run(test_dir, out, "--max_pockets", "2", "--resume")
    assert again == dict(written=0, resumed=2, skipped=0, retries=0,
                         generations=0)
    assert capsys.readouterr().out.count("skipped (resume)") == 2
    assert times_lines(out) == []


def test_batch_mode_with_atp_and_resume(test_dir, tmp_path, capsys):
    out = tmp_path / "batch"
    summary = run(test_dir, out, "--batch_pockets", "2", "--SVDD", "1")
    assert summary == dict(written=3, resumed=0, skipped=0, retries=0,
                           generations=2)
    assert sorted(os.listdir(out)) == ["p005_gen.sdf", "p048_gen.sdf",
                                       "p220_gen.sdf", "pocket_times.txt"]
    lines = times_lines(out)
    assert len(lines) == 2 and all(re.fullmatch(r"batch \d+\.\d\d", x)
                                   for x in lines)
    for name in POCKETS:
        assert len(read_sdf(str(out / f"{name}_gen.sdf"))) == 2
    printed = capsys.readouterr().out
    assert "batch of 2 pockets" in printed and "batch of 1 pockets" in \
        printed
    # one pocket's output removed: --resume runs that pocket alone
    os.remove(out / "p220_gen.sdf")
    again = run(test_dir, out, "--batch_pockets", "2", "--resume")
    assert again == dict(written=1, resumed=2, skipped=0, retries=0,
                         generations=1)
    assert (out / "p220_gen.sdf").exists()
    # the sweep's output through cli.evaluate
    report = evaluate.main([str(out), "--expected_per_file", "2"])
    assert report.splitlines()[0].startswith("p005_gen.sdf: n=2 ")


def test_batch_mode_groups_atp_by_pocket(test_dir, tmp_path, monkeypatch):
    """--batch_pockets sets ATPConfig(group_size=n_samples), so that a
    prune selects within each pocket's rows."""
    seen = []
    real = DiffNDM.generate_ligands_multi

    def spy(self, pdb_refs, seed=0):
        seen.append((self.sample_cfg.atp.group_size, len(pdb_refs), seed))
        return real(self, pdb_refs, seed)

    monkeypatch.setattr(DiffNDM, "generate_ligands_multi", spy)
    run(test_dir, tmp_path / "b", "--batch_pockets", "2", "--SVDD", "1",
        "--seed", "7")
    assert seen == [(2, 2, 7), (2, 1, 8)]


def test_inpaint_mode_and_resume(test_dir, tmp_path, monkeypatch):
    temps = []
    real_mkdtemp = __import__("tempfile").mkdtemp

    def mkdtemp(*a, **kw):
        temps.append(real_mkdtemp(*a, **kw))
        return temps[-1]

    monkeypatch.setattr("tempfile.mkdtemp", mkdtemp)
    out = tmp_path / "inpaint"
    summary = run(test_dir, out, "--inpaint", "--SVDD", "1",
                  "--resamplings", "2", "--max_pockets", "2")
    assert summary == dict(written=2, resumed=0, skipped=0, retries=0,
                           generations=2)
    assert sorted(os.listdir(out)) == ["p005_inpaint.sdf",
                                       "p048_inpaint.sdf",
                                       "pocket_times.txt"]
    assert all(re.fullmatch(r"\d+\.\d\d", x) for x in times_lines(out))
    assert len(times_lines(out)) == 2
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    for name in ("p005", "p048"):
        mols = read_sdf(str(out / f"{name}_inpaint.sdf"))
        n_lig = len(ds[POCKETS[name]].lig_coords)
        # whole molecules: the fixed quarter plus the 10 added atoms
        assert len(mols) == 2 and all(
            m.n_atoms == max(int(n_lig * 0.25), 1) + 10 for m in mols)
    # the fragment files went with their temporary directories
    assert len(temps) == 2 and not any(os.path.exists(t) for t in temps)
    again = run(test_dir, out, "--inpaint", "--resume", "--max_pockets",
                "2")
    assert again["resumed"] == 2 and again["generations"] == 0


@pytest.fixture()
def bad_dir(test_dir):
    """p005 intact, p048 with an unreadable PDB, p220 without an SDF."""
    bad = test_dir / "bad"
    if not bad.exists():
        bad.mkdir()
        for f in ("p005.pdb", "p005.sdf", "p048.sdf", "p220.pdb"):
            shutil.copy(test_dir / "pockets" / f, bad / f)
        (bad / "p048.pdb").write_text("not a PDB file\n")
    return test_dir


def test_data_errors_are_skipped_as_jax_skips_them(bad_dir, tmp_path,
                                                   capsys):
    out = tmp_path / "per_pocket"
    summary = run(bad_dir, out, "--max_tries", "2", "--oversample_maxiter",
                  "1", pockets="bad")
    # p048 tried twice and written empty (as the JAX sweep does), p220
    # skipped for its missing SDF
    assert summary == dict(written=2, resumed=0, skipped=2, retries=2,
                           generations=3)
    printed = capsys.readouterr().out
    assert "[retry 0] p048" in printed and "[retry 1] p048" in printed
    assert read_sdf(str(out / "p048_gen.sdf")) == []
    assert not (out / "p220_gen.sdf").exists()
    out = tmp_path / "inpaint"
    summary = run(bad_dir, out, "--inpaint", "--resamplings", "2",
                  pockets="bad")
    assert summary == dict(written=1, resumed=0, skipped=2, retries=0,
                           generations=1)
    assert "[skip] p048" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["p005_inpaint.sdf",
                                       "pocket_times.txt"]
    # --batch_pockets has no retry in the JAX sweep either: the batch
    # with the unreadable PDB stops the sweep
    with pytest.raises(ValueError):
        run(bad_dir, tmp_path / "batch", "--batch_pockets", "2",
            pockets="bad")


@pytest.mark.parametrize("mode,method", [
    ((), "generate_ligands"),
    (("--batch_pockets", "2"), "generate_ligands_multi"),
    (("--inpaint", "--resamplings", "2"), "inpaint")])
def test_a_runtime_error_stops_the_sweep(test_dir, tmp_path, monkeypatch,
                                         mode, method):
    def fail(*a, **kw):
        raise RuntimeError("gcl_messages: CUDA launch failed (error 700)")

    monkeypatch.setattr(DiffNDM, method, fail)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        run(test_dir, tmp_path / "out", *mode)
    assert not (tmp_path / "out" / "pocket_times.txt").exists()


def test_refuses_without_a_gpu(test_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main(["missing.npz", "--test_dir", str(test_dir / "pockets"),
                    "--outdir", str(tmp_path)])


def test_seeds_follow_the_generation_count(test_dir, tmp_path,
                                           monkeypatch):
    seeds = []
    real = DiffNDM.generate_ligands

    def spy(self, pdb_file, ref_ligand, seed=0, num_nodes_lig=None):
        seeds.append(seed)
        return real(self, pdb_file, ref_ligand, seed, num_nodes_lig)

    monkeypatch.setattr(DiffNDM, "generate_ligands", spy)
    summary = run(test_dir, tmp_path / "o", "--seed", "5",
                  "--oversample_maxiter", "3", "--sanitize")
    assert seeds == list(range(5, 5 + summary["generations"]))
    assert np.all(np.diff(seeds) == 1)
