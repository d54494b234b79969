"""Replay of a short unguided trajectory at full v3b width: the port's
sampler, fed the noise the JAX sampler's key schedule drew, against the
JAX sampler itself (T=10 steps over the T=500 schedule, one test
pocket, 4 samples, committed EMA weights).

Ten fp32 denoiser forwards whose sums run in another order compound to
well under 1e-3 A on the final coordinates (the stated tolerance); the
argmax atom types must be identical.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.core import CondDiffusion  # noqa: E402
from diffndm_tpu.diffusion.sampler import ConditionalSampler  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.config import SampleConfig  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.diffusion.sampler import SamplerNoise  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
COORD_ATOL = 1e-3  # Angstrom
STEPS, N_SAMPLES = 10, 4
SIZES = np.array([10, 13, 9, 14])


def jax_noise(key, shape, steps):
    """The normals the JAX sampler draws from ``key``
    (diffusion/sampler.py: init from the second half of the first split,
    step s from fold_in(run_key, s), the decode from fold_in(run_key,
    T + 1))."""
    run_key, k_init = jax.random.split(key)
    init = jax.random.normal(k_init, shape, jnp.float32)
    per_step = [jax.random.normal(
        jax.random.split(jax.random.fold_in(run_key, s), 4)[0], shape,
        jnp.float32) for s in range(steps)]
    decode = jax.random.normal(jax.random.fold_in(run_key, steps + 1),
                               shape, jnp.float32)
    return SamplerNoise(*(torch.from_numpy(np.array(a)) for a in
                          (init, np.stack(per_step), decode)))


def test_trajectory_replay_matches_jax():
    port = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                             sample_cfg=SampleConfig(pocket_pad_multiple=16),
                             device="cpu")
    port.load_params_npz(NPZ)
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[3]
    pocket = port.pocket_from_dataset(pair, N_SAMPLES)

    mcfg = jcfg.model_config_from_yaml(
        jcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    d = mcfg.diffusion
    core = CondDiffusion(jS.make_schedule(d.noise_schedule, d.timesteps,
                                          d.noise_precision), d,
                         mcfg.atom_nf, mcfg.residue_nf)
    with np.load(NPZ) as f:
        params = {}
        for k in f.files:
            node = params
            *head, leaf = k.split("/")
            for p in head:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(f[k])
    sampler = ConditionalSampler(
        core, EGNNDynamics(mcfg.egnn, atom_nf=mcfg.atom_nf,
                           residue_nf=mcfg.residue_nf), params,
        jcfg.SampleConfig(), dataset_params[mcfg.dataset])
    key = jax.random.PRNGKey(7)
    ref = sampler.sample_given_pocket(
        key, NodeBatch(*(jnp.asarray(a.numpy()) for a in pocket)), SIZES,
        timesteps=STEPS)

    nl = ref.ligand.x.shape[1]
    noise = jax_noise(key, (N_SAMPLES, nl, 3 + mcfg.atom_nf), STEPS)
    out = port.sample_given_pocket(pocket, SIZES, timesteps=STEPS,
                                   noise=noise)

    mask = np.asarray(ref.ligand.mask)
    np.testing.assert_array_equal(out.ligand.mask.numpy(), mask)
    x_ref, x_out = np.asarray(ref.ligand.x), out.ligand.x.numpy()
    assert np.all(np.isfinite(x_out))
    np.testing.assert_allclose(x_out, x_ref, rtol=0, atol=COORD_ATOL)
    m = mask > 0.5
    np.testing.assert_array_equal(out.ligand.h.numpy().argmax(-1)[m],
                                  np.asarray(ref.ligand.h).argmax(-1)[m])
    np.testing.assert_allclose(out.pocket.x.numpy(),
                               np.asarray(ref.pocket.x), rtol=0,
                               atol=COORD_ATOL)
    # the molecules built from the replayed ligands are the same
    mols = port.result_to_molecules(out)
    assert [m.n_atoms for m in mols] == list(SIZES)
