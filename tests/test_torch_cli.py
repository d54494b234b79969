"""The port's ``generate`` CLI: the JAX CLI's flags and defaults plus
``--device``; an end-to-end run on the CPU (a tiny model, SPSA + ATP, the
AdjustNet adjusting every step and trained by REINFORCE over two loops)
that writes one SDF record per sample and an AdjustNet checkpoint the JAX
package reads; ``--path`` loading it back; the committed v3b weights
through the ``.npz`` checkpoint argument; and the refusals: no GPU without
``--device cpu``, an orbax directory, ``--w_vina``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.cli import generate as jgenerate  # noqa: E402
from diffndm_tpu.models.adjust_net import \
    AdjustNetState as JaxAdjust  # noqa: E402
from diffndm_tpu_torch.chem.io import read_sdf, write_sdf  # noqa: E402
from diffndm_tpu_torch.chem.mol import Molecule  # noqa: E402
from diffndm_tpu_torch.cli import generate  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.models.adjust_net import AdjustNetState  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
DECODER = dataset_params["crossdock_full"]["atom_decoder"]
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


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A PDB (one ALA per atom of test pocket 220), its ligand as the
    reference SDF, and the tiny config."""
    d = tmp_path_factory.mktemp("cli")
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[220]
    lines = []
    for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                    pair.pocket_one_hot)):
        el = DECODER[int(oh.argmax())].upper()
        lines.append(f"ATOM  {i + 1:>5} {el:<4} ALA A{i + 1:>4}    "
                     f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
    pdb, sdf, yml = (str(d / n) for n in ("pocket.pdb", "ligand.sdf",
                                          "tiny.yml"))
    with open(pdb, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    write_sdf(sdf, [Molecule([DECODER[int(t)] for t in
                              pair.lig_one_hot.argmax(1)], [],
                             coords=pair.lig_coords.astype(np.float64))])
    with open(yml, "w") as f:
        f.write(TINY)
    return dict(dir=d, pdb=pdb, sdf=sdf, yml=yml)


def test_parser_matches_jax_plus_device():
    ours = {a.dest: (a.default, a.required, type(a).__name__)
            for a in generate.build_parser()._actions}
    ref = {a.dest: (a.default, a.required, type(a).__name__)
           for a in jgenerate.build_parser()._actions}
    assert ours.pop("device") == ("cuda", False, "_StoreAction")
    assert ours == ref


def test_cli_end_to_end_on_cpu(inputs, monkeypatch):
    """Two loops of generation + REINFORCE: the AdjustNet checkpoint is
    saved after each, and the two differ."""
    saved = []
    original = AdjustNetState.save

    def recording_save(self, path):
        original(self, path)
        saved.append([p.detach().clone() for p in self.module.parameters()])

    monkeypatch.setattr(AdjustNetState, "save", recording_save)
    out, ckpt = (str(inputs["dir"] / n) for n in ("out.sdf", "adjust.npz"))
    n = 3
    # 4 of the 8 steps: SPSA updates at s = 2, 0 and a prune at s = 0
    model = generate.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["yml"],
        "--pdbfile", inputs["pdb"], "--ref_ligand", inputs["sdf"],
        "--outfile", out, "--n_samples", str(n), "--timesteps", "4",
        "--num_nodes_lig", "7", "--SPSA", "1", "--SVDD", "1", "--optimize",
        "1", "--path_save", ckpt, "--rl_loops", "2", "--seed", "3",
        "--device", "cpu"])
    assert model.device == torch.device("cpu")
    assert model.sample_cfg.spsa.enabled and model.sample_cfg.atp.enabled
    assert model.sample_cfg.rl.enabled and model.sample_cfg.rl.train
    assert (model.sample_cfg.n_samples, model.sample_cfg.timesteps) == (n, 4)
    assert model.sample_cfg.largest_frag and not model.sample_cfg.sanitize
    mols = read_sdf(out)
    assert len(mols) == n and all(1 <= m.n_atoms <= 7 for m in mols)
    history = model.adjust_state.history
    assert len(history) == 2 and np.all(np.isfinite(history))
    assert len(saved) == 2
    assert any(not torch.equal(a, b) for a, b in zip(*saved))
    # JAX reads the checkpoint: the weights and the Adam state after two
    # updates
    ref = JaxAdjust(jcfg.RLConfig())
    ref.load(ckpt)
    p = ref.params["params"]
    for name in ("fc1", "fc2"):
        layer = getattr(model.adjust_state.module, name)
        np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                      np.asarray(p[name]["kernel"]).T)
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(p[name]["bias"]))
    assert int(np.asarray(ref.opt_state[0].count)) == 2

    # --path loads it back (one loop, no training)
    again = generate.main([
        str(inputs["dir"] / "missing.npz"), "--config", inputs["yml"],
        "--pdbfile", inputs["pdb"], "--ref_ligand", "A:1", "--outfile", out,
        "--n_samples", "2", "--optimize", "1", "--path", ckpt,
        "--all_frags", "--sanitize", "--relax", "--device", "cpu"])
    assert again.adjust_state.history == []
    sc = again.sample_cfg
    assert (sc.sanitize, sc.relax_iter, sc.largest_frag) == (True, 200, False)
    for a, b in zip(again.adjust_state.module.parameters(),
                    model.adjust_state.module.parameters()):
        assert torch.equal(a, b)
    assert len(read_sdf(out)) <= 2


def test_cli_loads_the_committed_npz(inputs):
    out = str(inputs["dir"] / "v3b.sdf")
    model = generate.main([
        NPZ, "--config", os.path.join(RUN, "hparams.yaml"), "--pdbfile",
        inputs["pdb"], "--ref_ligand", inputs["sdf"], "--outfile", out,
        "--n_samples", "2", "--timesteps", "2", "--num_nodes_lig", "6",
        "--device", "cpu"])
    with np.load(NPZ) as f:
        want = params_from_jax({k: f[k] for k in f.files})
    state = model.dynamics.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)
    assert model.adjust_state is None and model.oracle is None
    mols = read_sdf(out)
    assert len(mols) == 2 and all(m.n_atoms <= 6 for m in mols)


def test_generate_ligands_multi(inputs, tmp_path):
    """Two PDB pockets of different sizes in one batch: each gets its
    n_samples molecules, the second pocket's rows padded to the first's."""
    from diffndm_tpu_torch.config import ATPConfig, SampleConfig
    from diffndm_tpu_torch.model import DiffNDM

    other = str(tmp_path / "other.pdb")
    with open(inputs["pdb"]) as f:
        lines = [ln for ln in f if ln.startswith("ATOM")][:20]
    with open(other, "w") as f:
        f.write("".join(lines) + "END\n")
    model = DiffNDM.from_yaml(inputs["yml"], device="cpu", sample_cfg=
                              SampleConfig(n_samples=2, timesteps=2,
                                           atp=ATPConfig(enabled=True,
                                                         group_size=2),
                                           largest_frag=True),
                              scorer="python")
    out = model.generate_ligands_multi(
        [(inputs["pdb"], inputs["sdf"]), (other, inputs["sdf"])])
    assert list(out) == ["pocket.pdb", "other.pdb"]
    assert all(len(v) == 2 and all(m is not None and m.n_atoms >= 1
                                   for m in v) for v in out.values())
    model.sample_cfg = SampleConfig(n_samples=2, atp=ATPConfig(enabled=True))
    with pytest.raises(ValueError, match="group_size=2"):
        model.generate_ligands_multi(
            [(inputs["pdb"], inputs["sdf"]), (other, inputs["sdf"])])


def test_sample_config_sets_generation(inputs):
    """generate_ligands called with no settings takes the batch size, the
    step count, the AdjustNet switches and the output filters from the
    sample config."""
    from diffndm_tpu_torch.chem.bonds import build_molecule
    from diffndm_tpu_torch.chem.sanitize import process_molecule
    from diffndm_tpu_torch.config import RLConfig, SampleConfig
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.structs import to_lists

    cfg = SampleConfig(n_samples=3, timesteps=3, largest_frag=True,
                       sanitize=True, relax_iter=5,
                       rl=RLConfig(enabled=True, train=True))
    model = DiffNDM.from_yaml(inputs["yml"], device="cpu", sample_cfg=cfg,
                              scorer="python")
    forwards = []
    model.dynamics.register_forward_hook(lambda *_: forwards.append(1))
    mols, res = model.generate_ligands(inputs["pdb"], inputs["sdf"],
                                       num_nodes_lig=np.full(3, 6))
    assert res.ligand.x.shape[0] == 3 and len(mols) == 3
    assert len(forwards) == count_forwards(cfg, 3) == 4
    assert res.rl_traj[0].shape[0] == 3
    assert len(model.adjust_state.history) == 1
    assert float(res.avg_log_prob) < 0
    want = [process_molecule(build_molecule(c, t, model.dataset_info),
                             sanitize_flag=True, relax_iter=5,
                             largest_frag=True)
            for c, t in to_lists(res.ligand)]
    for a, b in zip(mols, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.symbols == b.symbols and a.bonds == b.bonds
            np.testing.assert_array_equal(a.coords, b.coords)


def test_cli_refusals(inputs, monkeypatch, tmp_path):
    base = ["--config", inputs["yml"], "--pdbfile", inputs["pdb"],
            "--ref_ligand", inputs["sdf"], "--outfile",
            str(tmp_path / "o.sdf"), "--n_samples", "2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main([str(tmp_path / "missing.npz")] + base)
    orbax_dir = tmp_path / "last"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        generate.main([str(orbax_dir)] + base + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="w_vina"):
        generate.main([str(tmp_path / "missing.npz")] + base + [
            "--device", "cpu", "--SPSA", "1", "--w_vina", "1.0"])
    with pytest.raises(SystemExit):
        generate.main([str(tmp_path / "missing.npz"), "--pdbfile",
                       inputs["pdb"], "--outfile", str(tmp_path / "o.sdf"),
                       "--device", "cpu"])
