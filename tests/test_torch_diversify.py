"""Diversification (partial noise-then-denoise, the step of the
evolutionary optimizer) of the port against the JAX package's
``DiversifySampler`` at full v3b width: a test ligand tiled to 4 rows in
its pocket, 5 noising steps over the T=500 schedule, the port fed every
normal the JAX key schedule drew; coordinates within 1e-3 A, atom types
identical.  And the batch helpers it uses (``repeat_batch``,
``ligand_node_batch``) equal to JAX's.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.data import pocket as jpocket  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.core import CondDiffusion as JaxCore  # noqa: E402
from diffndm_tpu.diffusion.diversify import \
    DiversifySampler as JaxDiversify  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu import structs as jstructs  # noqa: E402
from diffndm_tpu_torch.config import SampleConfig  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.data.pocket import ligand_node_batch  # noqa: E402
from diffndm_tpu_torch.diffusion.diversify import \
    DiversifyNoise  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch, repeat_batch  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
COORD_ATOL = 1e-3   # Angstrom
N_SAMPLES, NOISING_STEPS = 4, 5
ENC = {k: v for k, v in
       dataset_params["crossdock_full"]["atom_encoder"].items() if v < 10}


def test_batch_helpers_match_jax():
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[48]
    types = pair.lig_one_hot[:, :10].argmax(1)
    for kw in (dict(pad_multiple=8), dict(pad_multiple=16),
               dict(n_total=len(types) + 3)):
        mine = ligand_node_batch(pair.lig_coords, types, ENC, **kw)
        theirs = jpocket.ligand_node_batch(pair.lig_coords, types, ENC, **kw)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for k in (1, 3):
            for a, b in zip(repeat_batch(mine, k),
                            jstructs.repeat_batch(theirs, k)):
                assert a.shape == b.shape
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def jax_diversify_noise(key, shape, steps):
    """The normals JAX's diversify draws from ``key``: the noising from
    the second half of the first split; the reverse steps from a key
    chain (split, keep the first, use the second) seeded by the second
    split, step s = steps-1 first; the decode from the third split."""
    def normal(k):
        return np.array(jax.random.normal(k, shape, jnp.float32))

    key, k_noise = jax.random.split(key)
    key, k_scan = jax.random.split(key)
    per_step = {}
    for s in range(steps - 1, -1, -1):
        k_scan, k1 = jax.random.split(k_scan)
        per_step[s] = normal(k1)
    _, k_dec = jax.random.split(key)
    return DiversifyNoise(*(torch.from_numpy(a) for a in (
        normal(k_noise), np.stack([per_step[s] for s in range(steps)]),
        normal(k_dec))))


def test_diversify_replay_matches_jax():
    port = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                             sample_cfg=SampleConfig(pocket_pad_multiple=16),
                             device="cpu")
    port.load_params_npz(NPZ)
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[3]
    pocket = port.pocket_from_dataset(pair, N_SAMPLES)
    ligand = repeat_batch(ligand_node_batch(
        pair.lig_coords, pair.lig_one_hot[:, :10].argmax(1), ENC), N_SAMPLES)

    mcfg = jcfg.model_config_from_yaml(
        jcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    d = mcfg.diffusion
    core = JaxCore(jS.make_schedule(d.noise_schedule, d.timesteps,
                                    d.noise_precision), d, mcfg.atom_nf,
                   mcfg.residue_nf)
    with np.load(NPZ) as f:
        params = {}
        for k in f.files:
            node = params
            *head, leaf = k.split("/")
            for p in head:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(f[k])
    sampler = JaxDiversify(core, EGNNDynamics(
        mcfg.egnn, atom_nf=mcfg.atom_nf, residue_nf=mcfg.residue_nf), params)
    key = jax.random.PRNGKey(5)
    ref = sampler.diversify(
        key, jstructs.NodeBatch(*(jnp.asarray(a.numpy()) for a in ligand)),
        jstructs.NodeBatch(*(jnp.asarray(a.numpy()) for a in pocket)),
        noising_steps=NOISING_STEPS)

    noise = jax_diversify_noise(key, tuple(ligand.x.shape[:2]) + (13,),
                                NOISING_STEPS)
    forwards = []
    port.dynamics.register_forward_hook(lambda *a: forwards.append(1))
    out = port.diversify(ligand, pocket, NOISING_STEPS, noise=noise)
    assert len(forwards) == NOISING_STEPS + 1
    mask = ligand.mask.numpy()
    np.testing.assert_array_equal(out.ligand.mask.numpy(), mask)
    x_out = out.ligand.x.numpy()
    assert np.all(np.isfinite(x_out))
    np.testing.assert_allclose(x_out, np.asarray(ref.ligand.x), rtol=0,
                               atol=COORD_ATOL)
    m = mask > 0.5
    np.testing.assert_array_equal(out.ligand.h.numpy().argmax(-1)[m],
                                  np.asarray(ref.ligand.h).argmax(-1)[m])
    np.testing.assert_allclose(out.pocket.x.numpy(),
                               np.asarray(ref.pocket.x), rtol=0,
                               atol=COORD_ATOL)
    # a light noising keeps each ligand near its pose, but moves it
    moved = np.abs(x_out - ligand.x.numpy())[m]
    assert 1e-3 < moved.max() and moved.mean() < 5.0
    # the generator path draws its own noise, reproducibly
    a, b = (port.diversify(ligand, pocket, 2, seed=1).ligand.x
            for _ in range(2))
    assert torch.equal(a, b)


def test_diversify_keeps_the_input_masks():
    port = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                             sample_cfg=SampleConfig(pocket_pad_multiple=16),
                             device="cpu")
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[48]
    pocket = port.pocket_from_dataset(pair, 2)
    ligand = repeat_batch(ligand_node_batch(
        pair.lig_coords, pair.lig_one_hot[:, :10].argmax(1), ENC), 2)
    out = port.diversify(ligand, pocket, 1, seed=0)
    assert isinstance(out.ligand, NodeBatch)
    assert torch.equal(out.ligand.mask, ligand.mask)
    assert torch.equal(out.pocket.mask, pocket.mask)
    assert out.row_src.tolist() == [0, 1]
