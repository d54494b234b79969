"""Replay of short trajectories at full v3b width: the port's sampler,
fed the noise the JAX sampler's key schedule drew, against the JAX sampler
itself (one test pocket, 4 samples, committed EMA weights): an unguided
one (T=10 steps over the T=500 schedule) and a guided one (T=12, with the
ATP, SPSA and hybrid windows scaled so that each event fires).

Ten to thirty fp32 denoiser forwards whose sums run in another order
compound to well under 1e-3 A on the final coordinates (the stated
tolerance); the argmax atom types, the masks and the rows selected by the
prunes must be identical.

Both kinds are replayed once more with the RL AdjustNet adjusting every
step (``optimize``) and the REINFORCE stacks kept (``collect_rl``), the
AdjustNet's weights carried over from a flax init: ``avg_log_prob``
within rtol 1e-4; the (z_t, eps) stacks within 1e-4 of their largest
magnitude, and each element within the coordinates' 1e-3.
"""

import functools
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
from diffndm_tpu.models.adjust_net import \
    AdjustNetState as JaxAdjust  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,  # noqa: E402
                                      SPSAConfig)
from diffndm_tpu_torch.convert import adjust_params_from_jax  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.diffusion.sampler import (SamplerNoise,  # noqa: E402
                                                 count_forwards,
                                                 guidance_events)
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
COORD_ATOL = 1e-3  # Angstrom
RL_RTOL, RL_SCALE = 1e-4, 1e-4
ADJUST_SCALE = 0.1
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


def make_port(sample_cfg):
    port = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                             sample_cfg=sample_cfg, device="cpu",
                             scorer="native")
    port.load_params_npz(NPZ)
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[3]
    return port, port.pocket_from_dataset(pair, N_SAMPLES)


@functools.lru_cache(maxsize=None)     # one compile per config
def make_jax_sampler(sample_cfg):
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
    return mcfg, ConditionalSampler(
        core, EGNNDynamics(mcfg.egnn, atom_nf=mcfg.atom_nf,
                           residue_nf=mcfg.residue_nf), params,
        sample_cfg, dataset_params[mcfg.dataset])


def with_adjust(port, sampler, seed):
    """The same AdjustNet on both sides: a flax init with the output layer
    scaled by ADJUST_SCALE, adjustments of the size a policy that has
    learned something makes (a fresh init adds O(1) to eps and drives a
    12-step guided trajectory hundreds of A away).  Returns the JAX
    keyword arguments of an adjusted, collected run."""
    jstate = JaxAdjust(jcfg.RLConfig(), key=jax.random.PRNGKey(seed))
    jstate.params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * ADJUST_SCALE if "fc2" in jax.tree_util.keystr(
            path) else v, jstate.params)
    port.ensure_adjust().module.load_state_dict(
        adjust_params_from_jax(jax.device_get(jstate.params)))
    sampler.adjust_module = jstate.module
    return dict(adjust_params=jstate.params, optimize=True, collect_rl=True)


def check_rl(out, ref, steps):
    """avg_log_prob and the REINFORCE stacks against JAX's: each stack's
    largest difference within RL_SCALE of its largest magnitude, and every
    element within the coordinates' COORD_ATOL (an element of eps is a
    denoiser output, which the forward amplifies like the coordinates)."""
    assert out.rl_traj[0].shape == (steps,) + tuple(out.ligand.x.shape[:2]) \
        + (out.rl_traj[0].shape[-1],)
    for name, mine, theirs in zip(("z", "eps"), out.rl_traj, ref.rl_traj):
        mine, theirs = mine.numpy(), np.asarray(theirs)
        assert mine.shape == theirs.shape
        err = float(np.abs(mine - theirs).max())
        assert err <= RL_SCALE * float(np.abs(theirs).max()), (name, err)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=COORD_ATOL)
    lp = float(out.avg_log_prob)
    assert lp < 0
    np.testing.assert_allclose(lp, float(ref.avg_log_prob), rtol=RL_RTOL)


@pytest.mark.parametrize("adjust", [False, True], ids=["plain", "adjust"])
def test_trajectory_replay_matches_jax(adjust):
    port, pocket = make_port(SampleConfig(pocket_pad_multiple=16))
    mcfg, sampler = make_jax_sampler(jcfg.SampleConfig())
    rl = with_adjust(port, sampler, seed=2) if adjust else {}
    key = jax.random.PRNGKey(7)
    ref = sampler.sample_given_pocket(
        key, NodeBatch(*(jnp.asarray(a.numpy()) for a in pocket)), SIZES,
        timesteps=STEPS, **rl)

    nl = ref.ligand.x.shape[1]
    noise = jax_noise(key, (N_SAMPLES, nl, 3 + mcfg.atom_nf), STEPS)
    out = port.sample_given_pocket(pocket, SIZES, timesteps=STEPS,
                                   noise=noise, optimize=adjust,
                                   collect_rl=adjust)
    if adjust:
        check_rl(out, ref, STEPS)
    else:
        assert out.rl_traj is None and float(out.avg_log_prob) == 0.0

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


# ---------------------------------------------------------------------------
# guided
# ---------------------------------------------------------------------------

G_STEPS = 12
GUIDED = dict(
    spsa=dict(enabled=True, num_probes=2, start_step=6, every=2, zeta0=5.0),
    atp=dict(enabled=True, num_groups=4, start_step=10, every=5))


def jax_guided_noise(key, cfg, shape, steps):
    """Every normal the guided JAX sampler draws: per step s the keys
    k1..k4 = split(fold_in(run_key, s), 4) feed the step, the ATP prune
    (its branches), the SPSA update (its probes) and the hybrid (per
    branch a step key and a probe key)."""
    def normal(k, shp=shape):
        return np.array(jax.random.normal(k, shp, jnp.float32))

    def probes(k):
        return np.stack([normal(kk, shape[:2] + (3,)) for kk in
                         jax.random.split(k, cfg.spsa.num_probes)])

    g_extra = cfg.atp.num_groups - 1
    run_key, k_init = jax.random.split(key)
    events = guidance_events(cfg, steps)
    per_step, atp, spsa, hybrid = [], {}, {}, None
    for s in range(steps):
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(run_key, s), 4)
        per_step.append(normal(k1))
        if s in events["atp"]:
            k_branch, _ = jax.random.split(k2)
            atp[s] = np.stack([normal(bk) for bk in
                               jax.random.split(k_branch, g_extra)])
        if s in events["spsa"]:
            spsa[s] = probes(k3)
        if s in events["hybrid"]:
            k_branch, _ = jax.random.split(k4)
            pairs = [jax.random.split(bk) for bk in
                     jax.random.split(k_branch, g_extra)]
            hybrid = (np.stack([normal(p[0]) for p in pairs]),
                      np.stack([probes(p[1]) for p in pairs]))
    t = torch.from_numpy
    return SamplerNoise(
        t(normal(k_init)), t(np.stack(per_step)),
        t(normal(jax.random.fold_in(run_key, steps + 1))),
        atp={s: t(v) for s, v in atp.items()},
        spsa={s: t(v) for s, v in spsa.items()},
        hybrid=tuple(t(v) for v in hybrid))


@pytest.mark.parametrize("seed, adjust", [(7, False), (3, False),
                                          (7, True)])
def test_guided_trajectory_replay_matches_jax(seed, adjust):
    """ATP prunes at s = 10, 5, 0, SPSA updates at s = 6, 4, 2, 0 and the
    hybrid at s = 6, of 12 steps.  The rewards depend on perceived bonds,
    so a candidate on a perception threshold could fork the two sides;
    these seeds' trajectories have none (nor have seeds 1 and 2).  The
    global top-B collapses the population onto one input row here.  With
    ``adjust`` the AdjustNet adjusts the steps and the prunes' branch
    steps."""
    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(**GUIDED["spsa"]),
                       atp=ATPConfig(**GUIDED["atp"]))
    events = guidance_events(cfg, G_STEPS)
    assert events == dict(atp=[10, 5, 0], spsa=[6, 4, 2, 0], hybrid=[6])
    port, pocket = make_port(cfg)
    mcfg, sampler = make_jax_sampler(jcfg.SampleConfig(
        spsa=jcfg.SPSAConfig(**GUIDED["spsa"]),
        atp=jcfg.ATPConfig(**GUIDED["atp"])))
    rl = with_adjust(port, sampler, seed=5) if adjust else {}
    key = jax.random.PRNGKey(seed)
    ref = sampler.sample_given_pocket(
        key, NodeBatch(*(jnp.asarray(a.numpy()) for a in pocket)), SIZES,
        timesteps=G_STEPS, **rl)

    nl = ref.ligand.x.shape[1]
    noise = jax_guided_noise(key, cfg, (N_SAMPLES, nl, 3 + mcfg.atom_nf),
                             G_STEPS)
    forwards = []
    port.dynamics.register_forward_hook(
        lambda *a: forwards.append(1))
    out = port.sample_given_pocket(pocket, SIZES, timesteps=G_STEPS,
                                   noise=noise, optimize=adjust,
                                   collect_rl=adjust)

    # the AdjustNet adds no denoiser forward
    assert len(forwards) == count_forwards(cfg, G_STEPS) == 13 + 3 * 2 + 4 \
        + (2 + 3)
    if adjust:
        check_rl(out, ref, G_STEPS)
    mask = np.asarray(ref.ligand.mask)
    np.testing.assert_array_equal(out.ligand.mask.numpy(), mask)
    np.testing.assert_array_equal(out.pocket.mask.numpy(),
                                  np.asarray(ref.pocket.mask))
    # the surviving rows: each output row has the size of its origin row
    np.testing.assert_array_equal(SIZES[out.row_src.numpy()], mask.sum(1))
    assert port.oracle.n_scored > 0 and port.oracle.n_python_rows == 0
    x_ref, x_out = np.asarray(ref.ligand.x), out.ligand.x.numpy()
    assert np.all(np.isfinite(x_out))
    np.testing.assert_allclose(x_out, x_ref, rtol=0, atol=COORD_ATOL)
    m = mask > 0.5
    np.testing.assert_array_equal(out.ligand.h.numpy().argmax(-1)[m],
                                  np.asarray(ref.ligand.h).argmax(-1)[m])
    np.testing.assert_allclose(out.pocket.x.numpy(),
                               np.asarray(ref.pocket.x), rtol=0,
                               atol=COORD_ATOL)


def test_guided_sampler_needs_an_oracle_and_complete_noise():
    from diffndm_tpu_torch.diffusion.sampler import \
        ConditionalSampler as PortSampler

    cfg = SampleConfig(spsa=SPSAConfig(enabled=True))
    port, pocket = make_port(SampleConfig(pocket_pad_multiple=16))
    with pytest.raises(ValueError, match="oracle"):
        PortSampler(port.core, port.dynamics, cfg)
    guided, pocket = make_port(SampleConfig(
        pocket_pad_multiple=16, spsa=SPSAConfig(**GUIDED["spsa"])))
    shape = (N_SAMPLES, 16, 13)
    noise = SamplerNoise(torch.zeros(shape), torch.zeros((3,) + shape),
                         torch.zeros(shape))
    with pytest.raises(ValueError, match="SamplerNoise.spsa is missing"):
        guided.sample_given_pocket(pocket, SIZES, timesteps=3, noise=noise)
    # the affinity weight reaches the oracle's reward weights
    vina = SampleConfig(spsa=SPSAConfig(w_vina=0.5), atp=ATPConfig(
        w_vina=1.0))
    seen = []
    guided.oracle.rewards = lambda c, h, m, w: seen.append(w)
    guided.oracle.spsa_rewards(None, None, None, vina.spsa)
    guided.oracle.svdd_rewards(None, None, None, vina.atp)
    assert [w[6] for w in seen] == [0.5, 1.0]
