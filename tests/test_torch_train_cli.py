"""The port's train CLI end to end on the CPU (a tiny model on
``data/processed/virtual``), as ``tests/test_train_cli.py`` runs the JAX
one: the metrics stream with train and val records and the chemistry
dashboard, ``best`` / ``last`` checkpoints that load back, the run's
``hparams.yaml`` (read back equal by PyYAML and by the port's own
reader), the resume merge, ``--set`` applied after it, and ``--device
cuda`` raising without a GPU."""

import json
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.cli.train import merge_resume_hparams as jax_merge  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.cli import train as train_cli  # noqa: E402
from diffndm_tpu_torch.train.trainer import load_train_state  # noqa: E402

CFG = {
    "run_name": "smoke",
    "dataset": "crossdock",
    "datadir": "data/processed/virtual",
    "mode": "pocket_conditioning",
    "pocket_representation": "full-atom",
    "batch_size": 4,
    "lr": 1.0e-3,
    "n_epochs": 2,
    "clip_grad": True,
    "accumulate_grad_batches": 2,
    "auxiliary_loss": True,
    "ema_decay": 0.9,
    "eval_epochs": 1,
    "loss_params": {"clamp_lj": 3.0, "max_weight": 0.001,
                    "schedule": "linear"},
    "egnn_params": {
        "joint_nf": 8, "hidden_nf": 16, "n_layers": 2, "inv_sublayers": 1,
        "attention": True, "tanh": True, "norm_constant": 1,
        "reflection_equivariant": False, "edge_cutoff_ligand": None,
        "edge_cutoff_pocket": 5.0, "edge_cutoff_interaction": 5.0,
        "remat": True},
    "diffusion_params": {
        "diffusion_steps": 10, "diffusion_noise_schedule": "polynomial_2",
        "diffusion_noise_precision": 5.0e-4, "diffusion_loss_type": "l2",
        "normalize_factors": [1, 4]},
}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_cli")
    cfg = dict(CFG, logdir=str(root / "runs"))
    cfg_path = root / "smoke.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    summary = train_cli.main(["--config", str(cfg_path), "--max_steps", "6",
                              "--device", "cpu"])
    return root, cfg_path, summary


def test_metrics_stream(tiny_run):
    root, _, summary = tiny_run
    outdir = root / "runs" / "smoke"
    lines = [json.loads(line) for line in open(outdir / "metrics.jsonl")]
    train = [r for r in lines if r["split"] == "train"]
    val = [r for r in lines if r["split"] == "val"]
    assert len(train) == 1 and len(val) == 1      # max_steps ends epoch 0
    assert summary["steps"] == 6 and train[0]["steps"] == 6.0
    assert np.isfinite(train[0]["loss"]) and np.isfinite(val[0]["loss"])
    assert all(np.isfinite(summary["train_losses"]))
    for k in ("step", "epoch", "time", "grad_norm", "epoch_seconds"):
        assert k in train[0]
    for k in ("Validity", "Connectivity", "Uniqueness", "Novelty", "QED",
              "SA", "LogP", "Lipinski", "Diversity", "kl_div_atom_types"):
        assert k in val[0], f"missing dashboard metric {k}"
    assert os.path.exists(outdir / "eval" / "eval_ep0.sdf") or \
        val[0]["Validity"] == 0.0


def test_checkpoints_load_back(tiny_run):
    root, _, summary = tiny_run
    outdir = root / "runs" / "smoke"
    for name in ("best.npz", "last.npz"):
        params, ema, step = load_train_state(str(outdir / name))
        assert step == 6 and ema is not None
        assert all(np.isfinite(v).all() for v in params.values())
    from diffndm_tpu_torch.model import DiffNDM

    model = DiffNDM.from_yaml(str(outdir / "hparams.yaml"), device="cpu")
    with np.load(outdir / "last.npz") as f:
        flat = {k[len("ema_params/"):]: f[k] for k in f.files
                if k.startswith("ema_params/")}
    np.savez(outdir / "ema.npz", **flat)
    model.load_params_npz(str(outdir / "ema.npz"))
    model.save_params_npz(str(outdir / "again.npz"))
    with np.load(outdir / "again.npz") as f:
        assert sorted(f.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(f[k], flat[k])


def test_hparams_yaml_reads_back_equal(tiny_run):
    root, cfg_path, _ = tiny_run
    text = open(root / "runs" / "smoke" / "hparams.yaml").read()
    written = yaml.safe_load(text)
    assert tcfg.parse_yaml(text) == written
    given = yaml.safe_load(open(cfg_path))
    assert written == given


def test_resume_merge_and_set_overrides(tiny_run, capsys):
    root, cfg_path, _ = tiny_run
    last = str(root / "runs" / "smoke" / "last.npz")
    raw = yaml.safe_load(open(cfg_path))
    raw["lr"] = 123.0             # the checkpoint's value must win
    raw["n_epochs"] = 7           # the invocation's cadence stays
    merged = train_cli.merge_resume_hparams(dict(raw), last)
    assert merged["lr"] == 1.0e-3 and merged["n_epochs"] == 7
    assert "overwritten" in capsys.readouterr().out
    # the same merge as the JAX CLI's, for a checkpoint in a run directory
    assert merged == jax_merge(dict(raw), last)
    out = train_cli.apply_overrides(merged, [
        "lr=3e-4", "egnn_params.n_layers=1", "loss_params.max_weight=0.01",
        "new_key=true"], pytest.fail)
    assert out["lr"] == "3e-4" and out["egnn_params"]["n_layers"] == 1
    assert out["loss_params"]["max_weight"] == 0.01
    assert out["new_key"] is True
    assert yaml.safe_load("v: 3e-4")["v"] == "3e-4"   # YAML 1.1, as above
    assert "not present" in capsys.readouterr().out


def test_resume_runs_from_a_checkpoint(tiny_run, tmp_path):
    root, cfg_path, _ = tiny_run
    last = str(root / "runs" / "smoke" / "last.npz")
    summary = train_cli.main([
        "--config", str(cfg_path), "--resume", last, "--max_steps", "2",
        "--device", "cpu", "--set", f"logdir={tmp_path}",
        "--set", "run_name=resumed", "--set", "eval_epochs=5"])
    assert summary["steps"] == 2 and not summary["val_losses"]
    params, _, step = load_train_state(str(tmp_path / "resumed" /
                                           "last.npz"))
    assert step == 8                   # 6 restored + 2
    assert not os.path.exists(tmp_path / "resumed" / "best.npz")


def test_cuda_default_raises_without_a_gpu(monkeypatch, tiny_run):
    _, cfg_path, _ = tiny_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", str(cfg_path), "--max_steps", "1"])


def test_flags_are_the_jax_clis_plus_device():
    import argparse

    from diffndm_tpu.cli import train as jax_cli

    ours = {a.dest for a in train_cli.parser()._actions
            if not isinstance(a, argparse._HelpAction)}
    src = open(jax_cli.__file__).read()
    for flag in ("--config", "--resume", "--max_steps", "--max_seconds",
                 "--set"):
        assert f'"{flag}"' in src
    assert ours == {"config", "resume", "max_steps", "max_seconds",
                    "overrides", "device"}
