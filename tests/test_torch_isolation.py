"""The port stands alone: no module of diffndm_tpu_torch/ and not
chip_smoke.py imports JAX, flax, optax, orbax or the JAX package (a GPU
deployment of the port has none of them).  The scan is static, over the
source, because the test process already holds JAX for the other tests,
so sys.modules cannot tell.  It reads its data from its own assets (not
from the JAX package's ``chem/data``) and builds the native scorer into
``build/``, never into ``native/``.  And an entry point with no device
given raises when there is no GPU instead of running on the CPU."""

import ast
import glob

import pytest

torch = pytest.importorskip("torch")

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diffndm_tpu"}
SOURCES = sorted(glob.glob("diffndm_tpu_torch/**/*.py", recursive=True)) + [
    "chip_smoke.py"]


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def string_constants(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.ClassDef,
                                    ast.FunctionDef))
                  and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docstrings]


def test_sources_found():
    assert "diffndm_tpu_torch/model.py" in SOURCES
    for module in ("chem/sanitize.py", "chem/descriptors.py",
                   "chem/morgan.py", "chem/properties.py", "chem/metrics.py",
                   "chem/native.py", "guidance/oracle.py",
                   "guidance/spsa.py", "guidance/atp.py", "data/pdb.py",
                   "data/pocket.py", "data/dataset.py", "cli/generate.py",
                   "models/adjust_net.py", "diffusion/inpaint.py",
                   "diffusion/diversify.py", "cli/inpaint.py",
                   "cli/optimize.py", "cli/fix_ligand.py",
                   "chem/fingerprints.py", "cli/evaluate.py",
                   "cli/sweep.py", "cli/debug.py", "cli/plot.py",
                   "train/losses.py", "train/trainer.py",
                   "train/metrics_logger.py", "train/eval_dashboard.py",
                   "data/virtual.py", "cli/train.py", "chem/scoring.py",
                   "chem/rmsd.py", "chem/dock.py", "chem/docking.py",
                   "diffusion/joint.py", "diffusion/node_distribution.py",
                   "utils/geometry.py", "diffusion/learned_gamma.py",
                   "chem/smiles.py", "data/process_crossdock.py",
                   "data/prepare_crossdocked.py",
                   "data/process_bindingmoad.py", "utils/flops.py",
                   "utils/profiling.py", "utils/visualization.py",
                   "parallel/mesh.py"):
        assert f"diffndm_tpu_torch/{module}" in SOURCES
    assert len(SOURCES) > 30


@pytest.mark.parametrize("path", SOURCES)
def test_reads_own_assets_and_never_writes_under_native(path):
    """No path into the JAX package's data directory; the files under
    ``native/`` are named only by chem/native.py, which reads its two
    sources there and writes its library under ``build``."""
    strings = string_constants(path)
    assert not [s for s in strings if "chem/data" in s]
    named = [s for s in strings if "native/" in s or s.endswith(".cpp")
             or "libchemgraph" in s]
    if path == "diffndm_tpu_torch/chem/native.py":
        assert sorted(named) == ["chemgraph.cpp", "chemscore.cpp"]
    else:
        assert not named


def test_native_scorer_paths():
    from diffndm_tpu_torch.chem import native, properties

    root = native.ROOT
    assert [str(p.relative_to(root)) for p in native.SOURCES] == [
        "native/chemgraph.cpp", "native/chemscore.cpp"]
    assert native.BUILD_DIR == root / "build"
    assert native.library_path().parent == root / "build"
    assert properties.FPSCORES.endswith(
        "diffndm_tpu_torch/assets/fpscores.npz")


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from diffndm_tpu_torch.device import resolve_device
    from diffndm_tpu_torch.model import DiffNDM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffNDM.from_yaml("configs/virtual_cond_v3b.yml")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_new_clis_raise_without_a_gpu(monkeypatch, tmp_path):
    """The inpaint and optimize CLIs left at their ``cuda`` default raise
    with no GPU, ``--objective vina`` too; on the CPU, ``--objective
    vina`` reads its receptor from ``--pdbfile`` (missing here; the
    objective end to end: tests/test_torch_vina_cli.py)."""
    from diffndm_tpu_torch.cli import inpaint, optimize

    missing = str(tmp_path / "missing.npz")
    inp = [missing, "--pdbfile", "p.pdb", "--outfile", "o.sdf",
           "--fix_atoms", "frag.sdf"]
    opt = [missing, "--pdbfile", "p.pdb", "--ref_ligand", "l.sdf",
           "--outfile", "o.sdf"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inpaint.main(inp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize.main(opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize.main(opt + ["--objective", "vina", "--device", "cuda"])
    with pytest.raises(FileNotFoundError, match="p.pdb"):
        optimize.main(opt + ["--objective", "vina", "--device", "cpu"])


def variant_config(change):
    """configs/virtual_cond_v3b.yml with ``change`` applied (``egnn`` and
    ``diffusion`` entries replace fields of those configs)."""
    import dataclasses

    from diffndm_tpu_torch.config import load_yaml, model_config_from_yaml

    change = dict(change)
    cfg = model_config_from_yaml(load_yaml("configs/virtual_cond_v3b.yml"))
    egnn = dataclasses.replace(cfg.egnn, **change.pop("egnn", {}))
    diffusion = dataclasses.replace(cfg.diffusion,
                                    **change.pop("diffusion", {}))
    return dataclasses.replace(cfg, egnn=egnn, diffusion=diffusion,
                               **change)


@pytest.mark.parametrize("change", [
    dict(mode="pocket_conditioning_simple"),
    dict(egnn=dict(sin_embedding=True)),
    dict(egnn=dict(aggregation_method="mean")),
    dict(egnn=dict(edge_embedding_dim=4)),
    dict(diffusion=dict(noise_schedule="learned", loss_type="vlb")),
    dict(egnn=dict(mode="gnn_dynamics"))])
def test_unported_variants_raise_instead_of_running(change):
    """The JAX package's model variants, once refused by the port, build
    on the CPU at v3b's width and run one forward (their agreement with
    JAX: tests/test_torch_variants.py and test_torch_learned_gamma.py);
    a learned schedule without the VLB objective is refused, as JAX
    refuses it."""
    from diffndm_tpu_torch.model import DiffNDM

    cfg = variant_config(change)
    model = DiffNDM(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    b, nl, npk = 2, 7, 12
    xh_lig = torch.randn(b, nl, 3 + cfg.atom_nf, generator=g)
    xh_poc = torch.randn(b, npk, 3 + cfg.residue_nf, generator=g) * 2
    lm, pm = torch.ones(b, nl), torch.ones(b, npk)
    lm[1, 5:] = 0
    with torch.no_grad():
        eps_lig, eps_poc = model.dynamics(xh_lig * lm[..., None],
                                          xh_poc, torch.tensor([0.1, 0.9]),
                                          lm, pm)
    assert eps_lig.shape == xh_lig.shape and eps_poc.shape == xh_poc.shape
    assert bool(torch.isfinite(eps_lig).all())
    assert model.core.simple == (cfg.mode == "pocket_conditioning_simple")
    assert (model.gamma is not None) == (
        cfg.diffusion.noise_schedule == "learned")
    if cfg.diffusion.noise_schedule == "learned":
        with pytest.raises(ValueError, match="vlb"):
            DiffNDM(variant_config(dict(diffusion=dict(
                noise_schedule="learned"))), device="cpu")
