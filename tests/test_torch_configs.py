"""Every committed configuration in the port, against the JAX package.

- Each ``configs/*.yml`` (4 joint, 4 CA, 4 Binding MOAD among them)
  builds a port ``DiffNDM`` with the JAX one's feature sizes, and a
  joint config a joint sampler; at reduced width (hidden 16, 1 layer) on
  the same seeded weights (one JAX tree loaded into both), one denoiser
  forward on the config's own kind of pocket equals JAX's within rtol
  1e-4, atol 1e-5 (as tests/test_torch_dynamics.py).  At the full published width, JAX's
  parameter tree (its shapes, from ``jax.eval_shape``) loads into the
  port's denoiser through ``params_from_jax`` with nothing missing or
  left over.
- CA pockets end to end: ``pocket_from_pdb`` equals JAX's on a PDB of
  standard residues; the generate, inpaint and sweep CLIs run a tiny CA
  config on the CPU; the train CLI runs a tiny joint config.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.model import DiffNDM as JaxDiffNDM  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.cli import generate, inpaint, sweep  # noqa: E402
from diffndm_tpu_torch.cli import train as train_cli  # noqa: E402
from diffndm_tpu_torch.convert import (  # noqa: E402
    flatten_tree, params_from_jax, params_to_jax)
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from test_torch_dynamics import unflatten  # noqa: E402
from test_torch_scoring import residue_pdb  # noqa: E402
from test_torch_train_cli import CFG as TRAIN_CFG  # noqa: E402

CONFIGS = sorted(glob.glob("configs/*.yml"))
NET_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(hidden_nf=16, joint_nf=8, n_layers=1)
TINY_CA = """dataset: 'crossdock'
mode: 'pocket_conditioning'
pocket_representation: 'CA'
egnn_params:
  edge_cutoff_ligand: null
  edge_cutoff_pocket: 8.0
  edge_cutoff_interaction: 8.0
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
  normalize_factors: [1, 1]
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(path):
    return (jcfg.model_config_from_yaml(jcfg.load_yaml(path)),
            tcfg.model_config_from_yaml(tcfg.load_yaml(path)))


def seeded_tree(cfg, seed):
    """Seeded weights of the port's denoiser as JAX's parameter tree (a
    JAX init costs seconds per config on the CPU)."""
    torch.manual_seed(seed)
    return unflatten(params_to_jax(EGNNDynamics(
        cfg.egnn, cfg.atom_nf, cfg.residue_nf).state_dict()))


def shrink(cfg):
    return dataclasses.replace(cfg, egnn=dataclasses.replace(cfg.egnn,
                                                             **SMALL))


def test_every_committed_config_is_listed():
    names = [os.path.basename(p) for p in CONFIGS]
    assert len(names) == 13
    assert sum("joint" in n for n in names) == 4
    assert sum("_ca_" in n for n in names) == 4
    assert sum(n.startswith("moad") for n in names) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_builds_and_forward_equals_jax(path):
    jm, tm = configs(path)
    for name in ("dataset", "mode", "pocket_representation", "atom_nf",
                 "residue_nf"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.egnn.update_pocket_coords == (tm.mode == "joint")
    jsmall, tsmall = shrink(jm), shrink(tm)
    jmodel = JaxDiffNDM(jsmall, params=seeded_tree(tsmall, len(path)))
    model = DiffNDM(tsmall, device="cpu")
    assert (model.joint_sampler is None) == (jmodel.joint_sampler is None)
    assert (model.joint_sampler is not None) == ("joint" in path)
    flat = {"/".join(str(k.key) for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jmodel.params)[0]}
    model.dynamics.load_state_dict(params_from_jax(flat), strict=True)

    # the config's own kind of pocket: CA nodes ~3.8 A apart, full-atom
    # ~1.5 A; coordinates normalised as the samplers feed them
    rng = np.random.default_rng(len(path))
    b, nl, npk = 2, 8, 24
    spread = 6.0 if tm.pocket_representation == "CA" else 3.0
    nx, nh = tm.diffusion.norm_values
    lm = np.ones((b, nl), np.float32)
    lm[1, 6:] = 0
    pm = np.ones((b, npk), np.float32)
    pm[0, 20:] = 0
    xh_l = np.concatenate([
        rng.normal(size=(b, nl, 3)) * 1.5 / nx,
        np.eye(tm.atom_nf)[rng.integers(0, tm.atom_nf, (b, nl))] / nh],
        -1).astype(np.float32) * lm[..., None]
    xh_p = np.concatenate([
        rng.normal(size=(b, npk, 3)) * spread / nx,
        np.eye(tm.residue_nf)[rng.integers(0, tm.residue_nf, (b, npk))]
        / nh], -1).astype(np.float32) * pm[..., None]
    t = np.array([0.1, 0.6], np.float32)
    args = (xh_l, xh_p, t, lm, pm)
    ref = jmodel.module.apply(jmodel.params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        out = model.dynamics(*(torch.from_numpy(a) for a in args))
    for name, o, r in zip(("eps_lig", "eps_pocket"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **NET_TOL)
    moved = bool(np.abs(out[1].numpy()[..., :3]).max() > 0)
    assert moved == (tm.mode == "joint")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_full_width_jax_tree_loads_into_the_port(path):
    jm, tm = configs(path)
    module = JaxDynamics(jm.egnn, atom_nf=jm.atom_nf, residue_nf=jm.residue_nf)
    shapes = jax.eval_shape(
        module.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 3 + jm.atom_nf)), jnp.zeros((1, 16,
                                                      3 + jm.residue_nf)),
        jnp.zeros((1,)), jnp.ones((1, 8)), jnp.ones((1, 16)))
    tree = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    model = DiffNDM(tm, device="cpu")
    model.dynamics.load_state_dict(params_from_jax(tree), strict=True)
    h = tm.egnn.hidden_nf
    gcl = model.dynamics.egnn.e_block_0.gcl_0
    assert tuple(gcl.edge_l2_kernel.shape) == (h, h)
    assert len(flatten_tree(tree)) == len(model.dynamics.state_dict())


@pytest.fixture(scope="module")
def ca_inputs(tmp_path_factory):
    """A PDB of standard residues with a HETATM ligand (A:100), the
    ligand as SDF, and the tiny CA config."""
    d = tmp_path_factory.mktemp("ca")
    pdb = residue_pdb(d / "receptor.pdb", seed=2)
    lig = [line for line in open(pdb) if line.startswith("HETATM")
           and " LIG " in line]
    coords = np.array([[float(line[30:38]), float(line[38:46]),
                        float(line[46:54])] for line in lig])
    sdf = str(d / "ligand.sdf")
    write_sdf(sdf, [Molecule([line[76:78].strip() for line in lig], [],
                             coords=coords)])
    (d / "tiny_ca.yml").write_text(TINY_CA)
    return dict(dir=d, pdb=pdb, sdf=sdf, yml=str(d / "tiny_ca.yml"))


def test_ca_pocket_from_pdb_equals_jax(ca_inputs):
    jm, tm = configs("configs/crossdock_ca_cond.yml")
    sc = dict(pocket_pad_multiple=16)
    jmodel = JaxDiffNDM(shrink(jm), sample_cfg=jcfg.SampleConfig(**sc),
                        params=seeded_tree(shrink(tm), 0))
    model = DiffNDM(shrink(tm), sample_cfg=tcfg.SampleConfig(**sc),
                    device="cpu")
    for ref_ligand in ("A:100", ca_inputs["sdf"]):
        ref = jmodel.pocket_from_pdb(ca_inputs["pdb"], ref_ligand, 3)
        out = model.pocket_from_pdb(ca_inputs["pdb"], ref_ligand, 3)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert out.h.shape[-1] == 20
        n = int(out.mask[0].sum())
        # one node per residue with a CA atom, typed by amino acid
        assert 0 < n < 28
        assert torch.equal(out.h[0, :n].sum(-1), torch.ones(n))


def test_ca_generate_cli_on_cpu(ca_inputs):
    out = str(ca_inputs["dir"] / "gen.sdf")
    model = generate.main([
        str(ca_inputs["dir"] / "missing.npz"), "--config", ca_inputs["yml"],
        "--pdbfile", ca_inputs["pdb"], "--ref_ligand", "A:100",
        "--outfile", out, "--n_samples", "3", "--timesteps", "3",
        "--num_nodes_lig", "6", "--all_frags", "--device", "cpu"])
    assert model.cfg.pocket_representation == "CA"
    assert model.cfg.residue_nf == 20
    mols = read_sdf(out)
    assert len(mols) == 3 and all(m.n_atoms == 6 for m in mols)


def test_ca_inpaint_cli_on_cpu(ca_inputs):
    out = str(ca_inputs["dir"] / "inpaint.sdf")
    res = inpaint.main([
        str(ca_inputs["dir"] / "missing.npz"), "--config", ca_inputs["yml"],
        "--pdbfile", ca_inputs["pdb"], "--outfile", out, "--fix_atoms",
        ca_inputs["sdf"], "--add_n_nodes", "2", "--n_samples", "2",
        "--timesteps", "3", "--resamplings", "2", "--device", "cpu"])
    assert res.pocket.h.shape[-1] == 20
    np.testing.assert_array_equal(res.ligand.mask.sum(1).numpy(), [6, 6])
    assert len(read_sdf(out)) == 2


def test_ca_sweep_cli_on_cpu(ca_inputs, tmp_path):
    pockets = tmp_path / "pockets"
    pockets.mkdir()
    for name in ("r1", "r2"):
        (pockets / f"{name}.pdb").write_text(open(ca_inputs["pdb"]).read())
        (pockets / f"{name}.sdf").write_text(open(ca_inputs["sdf"]).read())
    outdir = tmp_path / "out"
    sweep.main(["missing.npz", "--config", ca_inputs["yml"], "--test_dir",
                str(pockets), "--outdir", str(outdir), "--n_samples", "2",
                "--timesteps", "3", "--batch_pockets", "2", "--device",
                "cpu"])
    written = sorted(p.name for p in outdir.glob("*.sdf"))
    assert len(written) == 2
    assert all(len(read_sdf(str(outdir / n))) >= 1 for n in written)


def test_train_cli_runs_a_joint_config_on_cpu(tmp_path):
    """A joint config trains with the conditional loss, as the JAX CLI
    does: two micro-steps at tiny width."""
    cfg = dict(TRAIN_CFG, mode="joint", logdir=str(tmp_path / "runs"),
               n_epochs=1, eval_epochs=100, ema_decay=0.0)
    path = tmp_path / "joint.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    summary = train_cli.main(["--config", str(path), "--max_steps", "2",
                              "--device", "cpu"])
    assert summary["steps"] == 2
    assert np.all(np.isfinite(summary["train_losses"]))
    assert os.path.exists(os.path.join(summary["outdir"], "last.npz"))
