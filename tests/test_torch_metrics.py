"""The port's evaluation against the JAX package's, on the same molecules
and the same files, with exact equality: fingerprints (Morgan and path
bits, the Weisfeiler-Lehman key, diversity), ``BasicMolecularMetrics``,
``MoleculeProperties.evaluate*``, ``CategoricalDistribution``; the
``evaluate`` report (plain and ``--per_step``), ``debug sdf`` and
``plot.parse_report`` texts; the ``evaluate`` parser (JAX's plus
``--device``) and its docking flags (``--receptor`` rescoring ``==``
JAX's text, ``--dock`` on the CPU).  Also the port's refusals: an orbax
directory in ``debug ckpt``, plots without matplotlib.

Molecules: 48 ligands of the processed virtual_v3 test set, clean and
perturbed (partly invalid, partly fragmented), each built by both
packages' ``build_molecule``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.chem import fingerprints as jF  # noqa: E402
from diffndm_tpu.chem import metrics as jMet  # noqa: E402
from diffndm_tpu.chem.bonds import build_molecule as jax_build  # noqa: E402
from diffndm_tpu.cli import debug as jdebug  # noqa: E402
from diffndm_tpu.cli import evaluate as jevaluate  # noqa: E402
from diffndm_tpu.cli import plot as jplot  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu_torch.chem import fingerprints as tF  # noqa: E402
from diffndm_tpu_torch.chem import metrics as tMet  # noqa: E402
from diffndm_tpu_torch.chem.bonds import build_molecule  # noqa: E402
from diffndm_tpu_torch.chem.io import write_sdf  # noqa: E402
from diffndm_tpu_torch.cli import debug, evaluate, plot  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402

INFO, JINFO = dataset_params["crossdock_full"], jax_params["crossdock_full"]


def ligand_items():
    """16 test ligands clean, at 0.15 A and at 0.5 A of noise."""
    rng = np.random.default_rng(3)
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    clean = [(ds[i].lig_coords.astype(np.float64),
              ds[i].lig_one_hot.argmax(-1)) for i in range(0, 160, 10)]
    return clean + [(c + rng.normal(size=c.shape) * s, t)
                    for s in (0.15, 0.5) for c, t in clean]


@pytest.fixture(scope="module")
def mols():
    """(port molecules, JAX molecules) of the same items."""
    items = ligand_items()
    return ([build_molecule(c, t, INFO) for c, t in items],
            [jax_build(c, t, JINFO) for c, t in items])


def test_fingerprints_equal_jax(mols):
    tm, jm = mols
    assert len(tm) >= 32
    for a, b in zip(tm, jm):
        assert tF.morgan_bits(a) == jF.morgan_bits(b)
        assert tF.morgan_bits(a, radius=3, n_bits=1024) == \
            jF.morgan_bits(b, radius=3, n_bits=1024)
        assert tF.path_bits(a) == jF.path_bits(b)
        assert tF.wl_canonical_key(a) == jF.wl_canonical_key(b)
        assert a.canonical_smiles_like() == b.canonical_smiles_like()
    assert tF.diversity(tm) == jF.diversity(jm)
    assert tF.similarity(tm[0], tm[1]) == jF.similarity(jm[0], jm[1])
    assert tF.diversity(tm[:1]) == jF.diversity(jm[:1]) == 0.0
    assert tF.tanimoto(set(), set()) == 1.0
    # the keys tell molecules apart, and a molecule equals itself
    keys = [tF.wl_canonical_key(m) for m in tm[:16]]
    assert len(set(keys)) > 8
    assert tF.wl_canonical_key(tm[0]) == tF.wl_canonical_key(
        build_molecule(*ligand_items()[0], INFO))


def test_basic_molecular_metrics_equal_jax(mols):
    tm, jm = mols
    novel_to = [m.canonical_smiles_like() for m in tm[:6]]
    port = tMet.BasicMolecularMetrics(INFO, novel_to)
    ref = jMet.BasicMolecularMetrics(JINFO, novel_to)
    (nums, (valid, connected)) = port.evaluate_rdmols(tm)
    (jnums, (jvalid, jconnected)) = ref.evaluate_rdmols(jm)
    assert nums == jnums
    assert len(valid) == len(jvalid) and len(connected) == len(jconnected)
    assert [tF.wl_canonical_key(m) for m in connected] == \
        [jF.wl_canonical_key(m) for m in jconnected]
    # every rate is strictly between 0 and 1 on this set: each branch ran
    assert all(0.0 < v < 1.0 for v in nums), nums
    # no novelty list: novelty 0, as in JAX
    assert tMet.BasicMolecularMetrics(INFO).evaluate_rdmols(tm)[0] == \
        jMet.BasicMolecularMetrics(JINFO).evaluate_rdmols(jm)[0]
    items = ligand_items()[:12]
    assert port.evaluate(items)[0] == ref.evaluate(items)[0]
    assert port.evaluate_rdmols([])[0] == ref.evaluate_rdmols([])[0]


def test_molecule_properties_evaluate_equal_jax(mols):
    tm, jm = mols
    props, jprops = tMet.MoleculeProperties(), jMet.MoleculeProperties()
    pockets = [tm[0:16], tm[16:32], tm[32:48]]
    jpockets = [jm[0:16], jm[16:32], jm[32:48]]
    assert props.evaluate(pockets) == jprops.evaluate(jpockets)
    assert props.evaluate_new(pockets + [[None]]) == \
        jprops.evaluate_new(jpockets + [[None]])
    assert props.evaluate_mean(tm[:16]) == jprops.evaluate_mean(jm[:16])
    assert props.evaluate_mean([]) == jprops.evaluate_mean([])
    assert props.calculate_diversity(tm[:8]) == \
        jprops.calculate_diversity(jm[:8])


def test_categorical_distribution_equal_jax(mols):
    mapping = INFO["atom_encoder"]
    hist = {k: float(i + 1) for i, k in enumerate(mapping)}
    hist[next(iter(mapping))] = 0.0          # an empty training bin
    sample = [mapping[s] for m in mols[0] for s in m.symbols]
    port = tMet.CategoricalDistribution(hist, mapping)
    ref = jMet.CategoricalDistribution(hist, mapping)
    assert port.kl_divergence(sample) == ref.kl_divergence(sample)
    assert np.isnan(port.kl_divergence([])) and np.isnan(
        ref.kl_divergence([]))


@pytest.fixture(scope="module")
def sdf_dir(tmp_path_factory, mols):
    """SDF files written by the port from the port's molecules: per-step
    names (try_<step>.sdf), a sweep output, a file of invalid molecules
    only, and an empty file."""
    d = tmp_path_factory.mktemp("sdfs")
    tm = mols[0]
    write_sdf(str(d / "try_100.sdf"), tm[0:10])
    write_sdf(str(d / "try_20.sdf"), tm[10:20])
    write_sdf(str(d / "try_300.sdf"), tm[32:48])
    write_sdf(str(d / "pocket_gen.sdf"), tm[20:40])
    bad = [m for m in tm if not tMet.BasicMolecularMetrics(INFO)
           .compute_validity([m])[0]]
    assert len(bad) >= 2
    write_sdf(str(d / "bad.sdf"), bad[:2])
    write_sdf(str(d / "empty.sdf"), [])
    return d


@pytest.mark.parametrize("flags", [[], ["--expected_per_file", "16"],
                                   ["--per_step"]],
                         ids=["default", "expected", "per_step"])
def test_evaluate_report_equals_jax(sdf_dir, tmp_path, capsys, flags):
    out, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    report = evaluate.main([str(sdf_dir), "--out", out] + flags)
    printed = capsys.readouterr().out
    jevaluate.main([str(sdf_dir), "--out", jout] + flags)
    assert printed == capsys.readouterr().out
    assert open(out).read() == open(jout).read() == report + "\n"
    if "--per_step" in flags:
        assert [line.split(":")[0] for line in report.splitlines()] == [
            "step 20", "step 100", "step 300"]
    else:
        assert report.splitlines()[-1].startswith("AGGREGATE over ")
        assert "bad.sdf: n=2 valid_ratio=0.00" in report
    # one file
    one = str(sdf_dir / "pocket_gen.sdf")
    report = evaluate.main([one])
    mine = capsys.readouterr().out
    jevaluate.main([one])
    assert mine == capsys.readouterr().out == report + "\n"


def test_parse_report_equals_jax(sdf_dir, tmp_path):
    rep = str(tmp_path / "report.txt")
    evaluate.main([str(sdf_dir), "--out", rep])
    rows = plot.parse_report(rep)
    assert rows == jplot.parse_report(rep)
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)


def test_debug_sdf_equals_jax(sdf_dir, capsys):
    outs = []
    for name in ("pocket_gen.sdf", "bad.sdf", "empty.sdf"):
        debug.main(["sdf", str(sdf_dir / name)])
        outs.append(capsys.readouterr().out)
        jdebug.main(["sdf", str(sdf_dir / name)])
        assert outs[-1] == capsys.readouterr().out
    assert "valid=True" in outs[0] and "valid=False" in outs[1]
    assert outs[2] == ""


def test_debug_ckpt_and_devices(tmp_path, capsys):
    npz = tmp_path / "w.npz"
    np.savez(npz, **{"params/a/kernel": np.zeros((2, 3)),
                     "params/b": np.zeros(4)})
    debug.main(["ckpt", str(npz)])
    assert capsys.readouterr().out.splitlines() == [
        "params/a/kernel (2, 3)", "params/b (4,)"]
    pt = tmp_path / "w.pt"
    torch.save({"state_dict": {"x": torch.zeros(5, 2)}, "epoch": 3}, pt)
    debug.main(["ckpt", str(pt)])
    jdebug.main(["ckpt", str(pt)])
    out = capsys.readouterr().out.splitlines()
    assert out == ["x (5, 2)"] * 2
    with pytest.raises(ValueError, match="orbax"):
        debug.main(["ckpt", str(tmp_path)])
    debug.main(["devices"])
    out = capsys.readouterr().out
    assert "cuda available: False" in out and "device count: 0" in out


def parser_actions(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type,
                   a.nargs, a.required, a.const, a.choices)
                  for a in parser._actions if a.dest != "help")


def test_evaluate_parser_equals_jax():
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jevaluate.main(["x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    ours = parser_actions(evaluate.build_parser())
    assert [a for a in ours if a[1] == "device"] == [
        (("--device",), "device", "cuda", str, None, False, None, None)]
    assert [a for a in ours if a[1] != "device"] == \
        parser_actions(captured["parser"])


@pytest.fixture(scope="module")
def receptor(tmp_path_factory):
    """Test pocket 0 as PDB, one ALA residue per atom."""
    from test_torch_scoring import pocket_pdb

    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[0]
    return pocket_pdb(pair, tmp_path_factory.mktemp("receptor") / "r.pdb")


@pytest.mark.parametrize("flags", [["--receptor", "r.pdb"],
                                   ["--receptor", "r.pdb", "--dock"],
                                   ["--dock"]])
def test_evaluate_docking_flags_raise(sdf_dir, receptor, flags, tmp_path,
                                      capsys, monkeypatch):
    """The docking flags work: ``--receptor`` appends the JAX CLI's
    `` Vina~=`` to each file's line, equal to its text; with ``--dock``
    (on the CPU, 2 restarts, try_20.sdf alone) a finite `` dock~=``
    instead; ``--dock`` alone changes nothing and touches no device."""
    flags = [receptor if f == "r.pdb" else f for f in flags]
    target = str(sdf_dir / "try_20.sdf") if "--receptor" in flags and \
        "--dock" in flags else str(sdf_dir)
    jflags = [f for f in flags if f != "--dock"]
    jevaluate.main([target, "--out", str(tmp_path / "jax.txt")] + jflags)
    want = (tmp_path / "jax.txt").read_text()
    capsys.readouterr()
    if "--receptor" not in flags:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert evaluate.main([target] + flags) + "\n" == want
        return
    if "--dock" not in flags:
        assert evaluate.main([target] + flags) + "\n" == want
        assert "UNCALIBRATED" in capsys.readouterr().out
        assert want.count(" Vina~=") >= 4
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # small tensors: one thread is faster
    try:
        got = evaluate.main([target] + flags + ["--device", "cpu",
                                                "--dock_restarts", "2"])
    finally:
        torch.set_num_threads(threads)
    lines, jlines = got.splitlines(), want.splitlines()
    assert len(lines) == len(jlines)
    n_docked = 0
    for line, jline in zip(lines, jlines):
        if " Vina~=" not in jline:
            assert line == jline
            continue
        head, value = line.split(" dock~=")
        assert head == jline.split(" Vina~=")[0]
        assert np.isfinite(float(value))
        n_docked += 1
    assert n_docked == 1


def test_plots_need_matplotlib(sdf_dir, tmp_path, monkeypatch):
    """With matplotlib the violins come out as the JAX CLI names them;
    without it (the GPU machine) each plot raises an ImportError that
    says so."""
    rep = str(tmp_path / "report.txt")
    evaluate.main([str(sdf_dir), "--out", rep])
    pytest.importorskip("matplotlib")
    plot.main([f"origin={rep}", f"SPSA={rep}", "--outdir",
               str(tmp_path / "port")])
    assert sorted(os.listdir(tmp_path / "port")) == [
        "lipinski_violin.png", "logp_violin.png", "qed_violin.png",
        "sa_violin.png"]
    jsonl = tmp_path / "metrics.jsonl"
    jsonl.write_text('{"step": 1, "split": "train", "loss": 1.0}\n'
                     '{"step": 2, "split": "val", "loss": 0.5}\n')
    plot.main([str(jsonl), "--outdir", str(tmp_path / "curves"),
               "--curves"])
    assert os.listdir(tmp_path / "curves") == ["curve_loss.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for argv in ([f"origin={rep}", "--outdir", str(tmp_path / "x")],
                 [str(jsonl), "--outdir", str(tmp_path / "y"), "--curves"]):
        with pytest.raises(ImportError, match="matplotlib"):
            plot.main(argv)
    assert plot.parse_report(rep) == jplot.parse_report(rep)
