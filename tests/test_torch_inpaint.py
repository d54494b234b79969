"""RePaint inpainting of the port against the JAX package.

- The core functions (``gamma_int``, ``noised_representation``,
  ``sample_p_zt_given_zs``) and ``repaint_combine`` on seeded inputs with
  the noise JAX drew: atol 1e-5.
- Replays at full v3b width (committed EMA weights, one test pocket, 4
  samples, the first quarter of its test ligand fixed plus 4 atoms), the
  port fed every normal the JAX key schedule drew: unguided T=4 x R=3 with
  both centres, and guided T=6 x R=2 with the SPSA and ATP windows scaled
  so that both hooks fire.  In the guided replay the rows differ (fixed
  atoms, added atoms, and a translation of the whole input per row), so
  that a prune that replicates a row shows in the sizes, and a missed
  gather of a per-row quantity shows in the coordinates.  Coordinates
  within 1e-3 A (tens of fp32 forwards summed in another order); atom
  types, masks and the surviving rows identical.
- The forward count the config derives equals the denoiser's calls, and
  missing noise raises.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params  # noqa: E402
from diffndm_tpu.diffusion import inpaint as jinpaint  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.core import CondDiffusion as JaxCore  # noqa: E402
from diffndm_tpu.guidance.oracle import \
    RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxBatch  # noqa: E402
from diffndm_tpu_torch.config import (ATPConfig, DiffusionConfig,  # noqa: E402
                                      InpaintConfig, SampleConfig,
                                      SPSAConfig)
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as S  # noqa: E402
from diffndm_tpu_torch.diffusion.core import CondDiffusion  # noqa: E402
from diffndm_tpu_torch.diffusion.inpaint import (  # noqa: E402
    InpaintNoise, count_inpaint_forwards, inpaint_events, repaint_combine)
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch, pad_to  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
COORD_ATOL = 1e-3   # Angstrom
CORE_ATOL = 1e-5
N_SAMPLES, ADD = 4, 4
PAIR = 3


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# core functions
# ---------------------------------------------------------------------------

def cores(T=500):
    d = DiffusionConfig(timesteps=T)
    port = CondDiffusion(S.make_schedule(d.noise_schedule, T,
                                         d.noise_precision), d, 10, 10)
    jd = jcfg.DiffusionConfig(timesteps=T)
    ref = JaxCore(jS.make_schedule(jd.noise_schedule, T, jd.noise_precision),
                  jd, 10, 10)
    return port, ref


def core_inputs(seed, b=3, nl=8, npk=12):
    rng = np.random.default_rng(seed)
    lm = (np.arange(nl)[None] < np.array([[8], [5], [6]])[:b]).astype(
        np.float32)
    pm = (np.arange(npk)[None] < np.array([[12], [9], [10]])[:b]).astype(
        np.float32)
    xl = (rng.normal(size=(b, nl, 13)) * lm[..., None]).astype(np.float32)
    xp = (rng.normal(size=(b, npk, 13)) * 2 * pm[..., None]).astype(
        np.float32)
    steps = np.array([3, 250, 499])[:b]
    return xl, xp, lm, pm, steps


def test_gamma_int_matches_jax():
    port, ref = cores()
    steps = np.array([0, 1, 17, 250, 499, 500])
    np.testing.assert_array_equal(port.gamma_int(torch.from_numpy(steps))
                                  .numpy(),
                                  np.asarray(ref.gamma_int(steps)))


def test_noised_representation_and_renoise_match_jax():
    port, ref = cores()
    xl, xp, lm, pm, steps = core_inputs(0)
    key = jax.random.PRNGKey(4)
    g_t = ref.gamma_int(jnp.asarray(steps))
    z, p, eps = ref.noised_representation(key, xl, xp, lm, pm, g_t)
    noise = t(jax.random.normal(key, xl.shape, jnp.float32))
    z2, p2, eps2 = port.noised_representation(
        t(xl), t(xp), t(lm), t(pm), port.gamma_int(t(steps)), noise=noise)
    for mine, theirs in ((z2, z), (p2, p), (eps2, eps)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=0, atol=CORE_ATOL)

    g_s = ref.gamma_int(jnp.asarray(steps - 1))
    z, p = ref.sample_p_zt_given_zs(key, xl, xp, lm, pm, g_t, g_s)
    z2, p2 = port.sample_p_zt_given_zs(
        t(xl), t(xp), t(lm), t(pm), port.gamma_int(t(steps)),
        port.gamma_int(t(steps - 1)), noise=noise)
    np.testing.assert_allclose(z2.numpy(), np.asarray(z), rtol=0,
                               atol=CORE_ATOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p), rtol=0,
                               atol=CORE_ATOL)


@pytest.mark.parametrize("u", [0, 2], ids=["renoise", "last"])
def test_repaint_combine_matches_jax(u):
    port, ref = cores()
    xl, xp, lm, pm, steps = core_inputs(1)
    rng = np.random.default_rng(2)
    b, nl = lm.shape
    fixed = ((np.arange(nl)[None] < np.array([[3], [2], [4]]))
             * lm)[..., None].astype(np.float32)
    l_x = (rng.normal(size=(b, nl, 3)) * lm[..., None]).astype(np.float32)
    l_h = (rng.normal(size=(b, nl, 10)) * lm[..., None]).astype(np.float32)
    com_p0 = rng.normal(size=(b, 1, 3)).astype(np.float32)
    k3, k4 = jax.random.split(jax.random.PRNGKey(9))
    g_s = ref.gamma_int(jnp.asarray(steps))
    g_t = ref.gamma_int(jnp.asarray(steps + 1))
    z, p = jinpaint.repaint_combine(ref, xl, xp, lm, pm, fixed, l_x, l_h,
                                    com_p0, g_s, g_t, k3, k4, u, 3)
    z2, p2 = repaint_combine(
        port, t(xl), t(xp), t(lm), t(pm), t(fixed), t(l_x), t(l_h),
        t(com_p0), port.gamma_int(t(steps)), port.gamma_int(t(steps + 1)),
        u, 3, noise_known=t(jax.random.normal(k3, xl.shape, jnp.float32)),
        noise_renoise=t(jax.random.normal(k4, xl.shape, jnp.float32)))
    np.testing.assert_allclose(z2.numpy(), np.asarray(z), rtol=0,
                               atol=CORE_ATOL)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p), rtol=0,
                               atol=CORE_ATOL)


# ---------------------------------------------------------------------------
# replays at full v3b width
# ---------------------------------------------------------------------------

def jax_inpaint_noise(key, cfg, shape, steps, resamplings, svdd, spsa):
    """Every normal the JAX inpainting loop draws from ``key``
    (diffusion/inpaint.py): the initial ligand from the second half of
    the first split; per (s, u) the keys k1..k4 = split(fold_in(fold_in(
    run_key, s), u), 4) for the reverse step, the SPSA probes, the known
    part and the re-noising; the ATP branches from fold_in(k_s, R + 1);
    the decode from fold_in(run_key, T + 1)."""
    def normal(k, shp=shape):
        return np.array(jax.random.normal(k, shp, jnp.float32))

    run_key, k0 = jax.random.split(key)
    ev = inpaint_events(cfg, steps, svdd, spsa)
    g_extra = cfg.atp.num_groups - 1
    step, known, renoise, spsa_n, atp = [], [], [], {}, {}
    for s in range(steps):
        k_s = jax.random.fold_in(run_key, s)
        rows = [jax.random.split(jax.random.fold_in(k_s, u), 4)
                for u in range(resamplings)]
        step.append([normal(k[0]) for k in rows])
        known.append([normal(k[2]) for k in rows])
        renoise.append([normal(k[3]) for k in rows[:-1]])
        if s in ev["spsa"]:
            spsa_n[s] = np.stack([
                normal(kk, shape[:2] + (3,))
                for kk in jax.random.split(rows[0][1],
                                           cfg.spsa.num_probes)])
        if s in ev["atp"]:
            k_branch, _ = jax.random.split(
                jax.random.fold_in(k_s, resamplings + 1))
            atp[s] = np.stack([normal(bk) for bk in
                               jax.random.split(k_branch, g_extra)])
    renoise = np.asarray(renoise, np.float32).reshape(
        (steps, resamplings - 1) + shape)
    return InpaintNoise(
        t(normal(k0)), t(np.asarray(step)), t(np.asarray(known)),
        t(renoise), t(normal(jax.random.fold_in(run_key, steps + 1))),
        spsa={s: t(v) for s, v in spsa_n.items()},
        atp={s: t(v) for s, v in atp.items()})


def make_port(sample_cfg):
    port = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                             sample_cfg=sample_cfg, device="cpu",
                             scorer="native")
    port.load_params_npz(NPZ)
    return port


@functools.lru_cache(maxsize=None)     # one compile per config
def make_jax_inpainter(sample_cfg):
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
    oracle = JaxOracle(dataset_params[mcfg.dataset])
    oracle.native = None                # the Python scorer
    return jinpaint.InpaintSampler(
        core, EGNNDynamics(mcfg.egnn, atom_nf=mcfg.atom_nf,
                           residue_nf=mcfg.residue_nf), params, sample_cfg,
        dataset_params[mcfg.dataset], oracle)


def inpaint_inputs(port, n_fixed, n_add, offsets):
    """Per row b: the first n_fixed[b] atoms of the test ligand fixed and
    n_add[b] added, the whole input translated by offsets[b] (A).
    Returns (ligand, lig_fixed, pocket)."""
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[PAIR]
    pocket = port.pocket_from_dataset(pair, N_SAMPLES)
    nf = port.cfg.atom_nf
    nl = pad_to(max(f + a for f, a in zip(n_fixed, n_add)), 8)
    x = np.zeros((N_SAMPLES, nl, 3), np.float32)
    h = np.zeros((N_SAMPLES, nl, nf), np.float32)
    mask = np.zeros((N_SAMPLES, nl), np.float32)
    fixed = np.zeros((N_SAMPLES, nl), np.float32)
    for b, (f, a) in enumerate(zip(n_fixed, n_add)):
        x[b, :f] = pair.lig_coords[:f] + offsets[b]
        h[b, :f] = pair.lig_one_hot[:f, :nf]
        mask[b, :f + a] = 1.0
        fixed[b, :f] = 1.0
    off = torch.from_numpy(np.asarray(offsets, np.float32))[:, None]
    pocket = NodeBatch((pocket.x + off) * pocket.mask[..., None], pocket.h,
                       pocket.mask)
    return (NodeBatch(t(x), t(h), t(mask)), t(fixed), pocket)


def quarter():
    pair = ProcessedLigandPocketDataset(
        "data/processed/virtual_v3/test.npz")[PAIR]
    return max(int(len(pair.lig_coords) * 0.25), 1)


def replay(port, jax_cfg, ligand, lig_fixed, pocket, steps, resamplings,
           svdd, spsa, center, seed):
    """JAX's inpaint and the port's, fed JAX's noise.  Returns both
    results and the port's denoiser forwards."""
    sampler = make_jax_inpainter(jax_cfg)
    key = jax.random.PRNGKey(seed)
    ref = sampler.inpaint(
        key, JaxBatch(*(jnp.asarray(a.numpy()) for a in ligand)),
        jnp.asarray(lig_fixed.numpy()),
        JaxBatch(*(jnp.asarray(a.numpy()) for a in pocket)),
        timesteps=steps, resamplings=resamplings, svdd=svdd, spsa=spsa,
        center=center)
    noise = jax_inpaint_noise(key, port.sample_cfg,
                              tuple(ligand.x.shape[:2]) + (13,), steps,
                              resamplings, svdd, spsa)
    forwards = []
    hook = port.dynamics.register_forward_hook(lambda *a: forwards.append(1))
    try:
        out = port.inpaint(ligand, lig_fixed, pocket, timesteps=steps,
                           resamplings=resamplings, svdd=svdd, spsa=spsa,
                           center=center, noise=noise)
    finally:
        hook.remove()
    return ref, out, len(forwards)


def check_same(out, ref):
    mask = np.asarray(ref.ligand.mask)
    np.testing.assert_array_equal(out.ligand.mask.numpy(), mask)
    np.testing.assert_array_equal(out.pocket.mask.numpy(),
                                  np.asarray(ref.pocket.mask))
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


@pytest.mark.parametrize("center", ["ligand", "pocket"])
def test_unguided_inpaint_replay_matches_jax(center):
    cfg = SampleConfig(pocket_pad_multiple=16)
    port = make_port(cfg)
    q = quarter()
    ligand, lig_fixed, pocket = inpaint_inputs(
        port, [q] * N_SAMPLES, [ADD] * N_SAMPLES, [(0.0, 0.0, 0.0)] * 4)
    ref, out, n_fwd = replay(port, jcfg.SampleConfig(), ligand, lig_fixed,
                             pocket, 4, 3, False, False, center, seed=7)
    assert n_fwd == count_inpaint_forwards(cfg, 4, 3, False, False) == 13
    assert port.oracle is None          # no guidance, no oracle built
    check_same(out, ref)
    np.testing.assert_array_equal(out.row_src.numpy(), np.arange(4))
    # the fixed atoms keep their geometry (the known part is re-noised
    # at gamma_s of the last step only)
    x_in, x_out = ligand.x.numpy()[:, :q], out.ligand.x.numpy()[:, :q]
    d_in = np.linalg.norm(x_in[:, :, None] - x_in[:, None], axis=-1)
    d_out = np.linalg.norm(x_out[:, :, None] - x_out[:, None], axis=-1)
    assert np.abs(d_in - d_out).max() < 1.5


G_STEPS, G_RES = 6, 2
GUIDED = dict(
    spsa=dict(num_probes=2, zeta0=5.0),
    atp=dict(num_groups=4),
    inpaint=dict(spsa_low=3, spsa_high=4, spsa_zeta_denom=300.0,
                 atp_start_step=4, atp_every=2))


@pytest.mark.parametrize("seed", [7])
def test_guided_inpaint_replay_matches_jax(seed):
    """SPSA at s = 4, 3 (u = 0) and ATP prunes at s = 4, 2, 0 of 6 steps
    x 2 resamplings; the global top-B prune replicates rows."""
    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(**GUIDED["spsa"]),
                       atp=ATPConfig(**GUIDED["atp"]),
                       inpaint=InpaintConfig(**GUIDED["inpaint"]))
    assert inpaint_events(cfg, G_STEPS, True, True) == dict(
        spsa=[4, 3], atp=[4, 2, 0])
    port = make_port(cfg)
    q = quarter()
    n_fixed = [q, max(q - 1, 1), q, max(q - 2, 1)]
    n_add = [q + ADD + b - f for b, f in enumerate(n_fixed)]
    sizes = np.array([f + a for f, a in zip(n_fixed, n_add)])
    assert len(set(sizes)) == N_SAMPLES
    offsets = [(0.0, 0.0, 0.0), (1.5, -0.5, 0.7), (-1.0, 2.0, 0.3),
               (0.4, 0.4, -1.2)]
    ligand, lig_fixed, pocket = inpaint_inputs(port, n_fixed, n_add,
                                               offsets)
    jax_cfg = jcfg.SampleConfig(
        spsa=jcfg.SPSAConfig(**GUIDED["spsa"]),
        atp=jcfg.ATPConfig(**GUIDED["atp"]),
        inpaint=jcfg.InpaintConfig(**GUIDED["inpaint"]))
    ref, out, n_fwd = replay(port, jax_cfg, ligand, lig_fixed, pocket,
                             G_STEPS, G_RES, True, True, "ligand", seed)
    assert n_fwd == count_inpaint_forwards(cfg, G_STEPS, G_RES, True,
                                           True) == 12 + 1 + 2 + 3 * 2
    assert port.oracle.n_scored > 0 and port.oracle.n_python_rows == 0
    row_src = out.row_src.numpy()
    # each output row has its origin row's size: with distinct sizes the
    # masks equal to JAX's fix the surviving rows
    np.testing.assert_array_equal(sizes[row_src],
                                  out.ligand.mask.numpy().sum(1))
    assert len(set(row_src.tolist())) < N_SAMPLES    # a row replicated
    check_same(out, ref)


def test_missing_inpaint_noise_raises():
    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(**GUIDED["spsa"]),
                       inpaint=InpaintConfig(**GUIDED["inpaint"]))
    port = make_port(cfg)
    ligand, lig_fixed, pocket = inpaint_inputs(
        port, [2] * N_SAMPLES, [ADD] * N_SAMPLES, [(0.0, 0.0, 0.0)] * 4)
    shape = tuple(ligand.x.shape[:2]) + (13,)
    z = torch.zeros(shape)
    steps, res = 5, 2
    noise = InpaintNoise(z, torch.zeros((steps, res) + shape),
                         torch.zeros((steps, res) + shape),
                         torch.zeros((steps, res - 1) + shape), z)
    with pytest.raises(ValueError, match="InpaintNoise.spsa is missing"):
        port.inpaint(ligand, lig_fixed, pocket, timesteps=steps,
                     resamplings=res, spsa=True, noise=noise)
    with pytest.raises(ValueError, match="InpaintNoise.atp is missing"):
        port.inpaint(ligand, lig_fixed, pocket, timesteps=steps,
                     resamplings=res, svdd=True, spsa=False,
                     noise=noise._replace(atp={}))
    with pytest.raises(ValueError, match="noise has shape"):
        port.inpaint(ligand, lig_fixed, pocket, timesteps=steps,
                     resamplings=res, spsa=False,
                     noise=noise._replace(known=noise.known[:, :, :1]))


def test_inpaint_config_is_checked():
    assert SampleConfig().inpaint == InpaintConfig()
    with pytest.raises(ValueError, match="inpaint.center"):
        SampleConfig(inpaint=InpaintConfig(center="middle"))
    with pytest.raises(NotImplementedError, match="jump_length"):
        SampleConfig(inpaint=InpaintConfig(jump_length=2))
    port = make_port(SampleConfig(pocket_pad_multiple=16))
    ligand, lig_fixed, pocket = inpaint_inputs(
        port, [2] * N_SAMPLES, [ADD] * N_SAMPLES, [(0.0, 0.0, 0.0)] * 4)
    with pytest.raises(ValueError, match="center must be"):
        port.inpaint(ligand, lig_fixed, pocket, timesteps=2, center="middle")
    with pytest.raises(ValueError, match="reward oracle"):
        port.inpaint_sampler.inpaint(ligand, lig_fixed, pocket, timesteps=2,
                                     svdd=True)
