"""The port stands alone: no module of diffndm_tpu_torch/ and not
chip_smoke.py imports JAX, flax, optax, orbax or the JAX package (a GPU
deployment of the port has none of them).  The scan is static, over the
source, because the test process already holds JAX for the other tests,
so sys.modules cannot tell.  And an entry point with no device given
raises when there is no GPU instead of running on the CPU."""

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


def test_sources_found():
    assert "diffndm_tpu_torch/model.py" in SOURCES
    assert len(SOURCES) > 20


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
        DiffNDM.from_yaml("configs/virtual_cond_v3b.yml")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("change", [
    dict(mode="pocket_conditioning_simple"),
    dict(egnn=dict(sin_embedding=True)),
    dict(egnn=dict(aggregation_method="mean")),
    dict(egnn=dict(edge_embedding_dim=4)),
    dict(egnn=dict(update_pocket_coords=True))])
def test_unported_variants_raise_instead_of_running(change):
    """Configurations this slice does not port are refused, never run
    with other semantics."""
    import dataclasses

    from diffndm_tpu_torch.config import load_yaml, model_config_from_yaml
    from diffndm_tpu_torch.model import DiffNDM

    cfg = model_config_from_yaml(load_yaml("configs/virtual_cond_v3b.yml"))
    egnn = dataclasses.replace(cfg.egnn, **change.pop("egnn", {}))
    cfg = dataclasses.replace(cfg, egnn=egnn, **change)
    with pytest.raises(NotImplementedError):
        DiffNDM(cfg, device="cpu")
