"""The port's guidance (``spsa_update``, ``atp_prune``,
``hybrid_spsa_prune``, ``select_candidates``) against the JAX package's
functions: the same denoiser weights (a small random EGNN converted by
``params_from_jax``, and once the committed v3b EMA weights), the same
state, the same noise (computed here from the keys the JAX functions
split), the real chemistry oracle on both sides.

The state is a batch of real test ligands in their pockets, slightly
perturbed, late in the trajectory (t = 10/500), so that most candidates
are valid molecules and the rewards are not all zero.  Selected indices
must be identical; tensors agree within atol 1e-5 + rtol 1e-4 (fp32
forwards whose sums run in another order).  Rewards are piecewise constant
in the coordinates (they depend on the perceived bonds), so a candidate
that sits on a bond-perception threshold could fork the two sides; the
seeds below give states where none does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.core import CondDiffusion as JaxCore  # noqa: E402
from diffndm_tpu.guidance import atp as jatp  # noqa: E402
from diffndm_tpu.guidance import spsa as jspsa  # noqa: E402
from diffndm_tpu.guidance.oracle import \
    RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.constants import (MARGIN2, MARGIN3,  # noqa: E402
                                         OB_COVALENT_RADII, dataset_params)
from diffndm_tpu_torch.convert import params_from_jax  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.diffusion.core import CondDiffusion  # noqa: E402
from diffndm_tpu_torch.guidance import atp, spsa  # noqa: E402
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
NF = 10
T, S_STEP = 500, 9
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
RUN = "examples/checkpoints/virtual_cond_v3b"


def state(rows, seed, sigma=0.03):
    """Real ligands in their pockets as a sampler state late in the
    trajectory: ligand-COM frame, types / 4, coordinates perturbed."""
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    pairs = [ds[i] for i in rows]
    rng = np.random.default_rng(seed)
    nl = -(-max(len(p.lig_coords) for p in pairs) // 8) * 8
    npk = -(-max(len(p.pocket_coords) for p in pairs) // 16) * 16
    b = len(pairs)
    z = np.zeros((b, nl, 3 + NF), np.float32)
    xh = np.zeros((b, npk, 3 + NF), np.float32)
    lm = np.zeros((b, nl), np.float32)
    pm = np.zeros((b, npk), np.float32)
    for i, p in enumerate(pairs):
        n, m = len(p.lig_coords), len(p.pocket_coords)
        com = p.lig_coords.mean(0)
        z[i, :n, :3] = p.lig_coords - com + rng.normal(size=(n, 3)) * sigma
        z[i, :n, :3] -= z[i, :n, :3].mean(0)
        z[i, :n, 3:] = p.lig_one_hot[:, :NF] / 4.0
        xh[i, :m, :3] = p.pocket_coords - com
        xh[i, :m, 3:] = p.pocket_one_hot[:, :NF] / 4.0
        lm[i, :n], pm[i, :m] = 1, 1
    return z, xh, lm, pm


def noise_state(b, nl, npk, seed):
    """Dense clouds of nitrogen atoms: each atom ends with four neighbours,
    one more than nitrogen's valence, so every candidate is an invalid
    molecule and every reward is 0."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, nl, 3 + NF)).astype(np.float32) * 0.9
    z[..., 3:] = 0
    z[..., 4] = 0.25
    xh = rng.normal(size=(b, npk, 3 + NF)).astype(np.float32) * 3
    return z, xh, np.ones((b, nl), np.float32), np.ones((b, npk), np.float32)


class Pair:
    """The two sides on the same weights."""

    def __init__(self, jax_cfg, params):
        module = JaxDynamics(jax_cfg, atom_nf=NF, residue_nf=NF)
        apply = jax.jit(module.apply)
        self.jax_eps = lambda z, xh, t, lm, pm: apply(params, z, xh, t, lm,
                                                      pm)
        d = jcfg.DiffusionConfig(timesteps=T)
        self.jax_core = JaxCore(jS.make_schedule(
            d.noise_schedule, T, d.noise_precision), d, NF, NF)
        self.jax_oracle = JaxOracle(jax_params["crossdock_full"])

        flat = {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    params)[0]}
        egnn = tcfg.EGNNConfig(**{f.name: getattr(jax_cfg, f.name) for f in
                                  dataclasses.fields(tcfg.EGNNConfig)})
        model = EGNNDynamics(egnn, NF, NF)
        model.load_state_dict(params_from_jax(flat), strict=True)
        model.eval()
        self.eps = lambda *a: model(*a)
        td = tcfg.DiffusionConfig(timesteps=T)
        self.core = CondDiffusion(tS.make_schedule(
            td.noise_schedule, T, td.noise_precision), td, NF, NF)
        self.oracle = RewardOracle(dataset_params["crossdock_full"],
                                   scorer="native")


@pytest.fixture(scope="module")
def small():
    cfg = jcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2,
                          edge_cutoff_pocket=5.0,
                          edge_cutoff_interaction=5.0)
    module = JaxDynamics(cfg, atom_nf=NF, residue_nf=NF)
    params = jax.jit(module.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 3 + NF)),
        jnp.zeros((1, 16, 3 + NF)), jnp.zeros((1,)), jnp.ones((1, 8)),
        jnp.ones((1, 16)))
    return Pair(cfg, params)


@pytest.fixture(scope="module")
def v3b():
    mj = jcfg.model_config_from_yaml(jcfg.load_yaml(f"{RUN}/hparams.yaml"))
    with np.load(NPZ) as f:
        params = {}
        for k in f.files:
            node = params
            *head, leaf = k.split("/")
            for p in head:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(f[k])
    return Pair(mj.egnn, params)


def times(b):
    """[B] times for the port; the JAX functions take them as scalars, as
    the JAX sampler's scan passes them."""
    s_norm = np.full((b,), S_STEP / T, np.float32)
    t_norm = np.full((b,), (S_STEP + 1) / T, np.float32)
    return s_norm, t_norm


def tt(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def spsa_draws(key, k, shape):
    """[k, B, NL, 3]: what spsa_update draws from ``key``."""
    return np.stack([normal(kk, shape) for kk in jax.random.split(key, k)])


def close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def copy_cfg(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


# ---------------------------------------------------------------------------
# SPSA
# ---------------------------------------------------------------------------

def run_spsa(pair, st, key, jc, zeta):
    z, xh, lm, pm = st
    _, t_norm = times(len(z))
    with torch.no_grad():
        ref = jspsa.spsa_update(key, pair.jax_core, pair.jax_eps,
                                pair.jax_oracle, *map(jnp.asarray, st),
                                jnp.float32(t_norm[0]), zeta, jc)
        draws = spsa_draws(key, jc.num_probes, z[..., :3].shape)
        out = spsa.spsa_update(pair.core, pair.eps, pair.oracle, *tt(*st),
                               tt(t_norm)[0], zeta,
                               copy_cfg(tcfg.SPSAConfig, jc),
                               noise=tt(draws)[0])
    return out, ref


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "sequential"])
def test_spsa_update_matches_jax(small, fuse):
    st = state([0, 5, 7, 11], seed=0)
    jc = jcfg.SPSAConfig(enabled=True, num_probes=3, fuse_probes=fuse)
    out, ref = run_spsa(small, st, jax.random.PRNGKey(11), jc, zeta=0.05)
    close(out[0], ref[0])
    close(out[1], ref[1])
    # the probes found reward differences: the ligand moved by more than
    # a rigid shift
    moved = np.abs(out[0].numpy() - st[0])[..., :3].max()
    assert moved > 1e-3
    assert small.oracle.n_scored > 0


def test_spsa_fused_equals_sequential_and_zero_zeta_is_identity(small):
    st = state([2, 3], seed=1)
    _, t_norm = times(2)
    draws = tt(np.random.default_rng(0).standard_normal(
        (2,) + st[0][..., :3].shape).astype(np.float32))[0]
    outs = []
    for fuse in (True, False):
        cfg = tcfg.SPSAConfig(enabled=True, num_probes=2, fuse_probes=fuse)
        with torch.no_grad():
            outs.append(spsa.spsa_update(
                small.core, small.eps, small.oracle, *tt(*st),
                tt(t_norm)[0], 0.05, cfg, noise=draws))
    close(outs[0][0], outs[1][0].numpy())
    with torch.no_grad():
        same = spsa.spsa_update(small.core, small.eps, small.oracle,
                                *tt(*st), tt(t_norm)[0], 0.0, cfg,
                                noise=draws)
    np.testing.assert_allclose(same[0].numpy(), st[0], atol=1e-6)


class ScoredProbes:
    """Records what each side's oracle is handed and returns: the x0
    lookahead of every probe row (coordinates in Angstrom, type scores,
    mask) and its reward.  ``close`` restores the oracles."""

    def __init__(self, pair):
        self.pair, self.jax, self.torch = pair, [], []
        jax_host, torch_host = (pair.jax_oracle.score_batch_host,
                                pair.oracle.rewards)

        def jax_side(coords, h, mask, weights):
            r = jax_host(coords, h, mask, weights)
            self.jax.append(tuple(np.array(a) for a in (coords, h, mask, r)))
            return r

        def torch_side(coords, h, mask, weights):
            r = torch_host(coords, h, mask, weights)
            self.torch.append(tuple(a.detach().cpu().numpy()
                                    for a in (coords, h, mask, r)))
            return r

        pair.jax_oracle.score_batch_host = jax_side
        pair.oracle.rewards = torch_side

    def close(self):
        del self.pair.jax_oracle.score_batch_host, self.pair.oracle.rewards


class FixedRewards:
    """An oracle that answers with the given rewards."""

    def __init__(self, rewards):
        self.rewards = torch.from_numpy(np.asarray(rewards))

    def spsa_rewards(self, coords, h, mask, cfg):
        assert coords.shape[0] == self.rewards.shape[0]
        return self.rewards


def perception_margin(coords, types, mask):
    """Per row: how far (Angstrom) the closest atom pair sits from a
    threshold of the bond perception (chem/bonds.py: connectivity, the
    0.4 A floor, aromatic, double and triple bond lengths), the least
    distance change that could change the perceived molecule."""
    info = dataset_params["crossdock_full"]
    dec = info["atom_decoder"]
    b1, b2, b3 = (np.asarray(info[k]) for k in ("bonds1", "bonds2",
                                                  "bonds3"))
    out = []
    for c, t, m in zip(coords, types, mask > 0.5):
        x, t = c[m].astype(np.float64), t[m]
        d = np.linalg.norm(x[:, None] - x[None], axis=-1) * 100.0
        rc = np.array([OB_COVALENT_RADII.get(dec[i], 77.0) for i in t])
        p1, p2, p3 = (b[t[:, None], t[None]] for b in (b1, b2, b3))
        inf = np.full_like(d, np.inf)
        cuts = (rc[:, None] + rc[None] + 45.0, np.full_like(d, 40.0),
                np.where(p2 > 0, (p1 + p2) / 2 + 6.0, inf),
                np.where(p2 > 0, p2 + MARGIN2, inf),
                np.where(p3 > 0, p3 + MARGIN3, inf))
        iu = np.triu_indices(len(x), 1)
        out.append(min(np.abs(d - cut)[iu].min() for cut in cuts) / 100.0)
    return np.array(out)


def type_margin(h, mask):
    """Per row: the least gap between the two largest type scores of an
    atom (the type is their argmax)."""
    top = np.sort(h, axis=-1)
    gap = np.where(mask > 0.5, top[..., -1] - top[..., -2], np.inf)
    return gap.min(-1)


def test_spsa_update_matches_jax_on_v3b(v3b):
    """One SPSA update on v3b's weights, held apart layer by layer: the
    probe forwards within the tolerance; the rewards equal on every probe
    row, each of which must sit further from every bond-perception
    threshold and type tie than the two sides' forwards differ (else the
    state would not test what it claims); the update from JAX's rewards;
    then the port's own update."""
    st = state([0, 5], seed=2)
    jc = jcfg.SPSAConfig(enabled=True, num_probes=2)
    key = jax.random.PRNGKey(5)
    probes = ScoredProbes(v3b)
    try:
        out, ref = run_spsa(v3b, st, key, jc, zeta=0.05)
    finally:
        probes.close()
    assert len(probes.jax) == len(probes.torch) == 1
    (cj, hj, mj, rj), (ct, ht, mt, rt) = probes.jax[0], probes.torch[0]
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(ct, cj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ht, hj, rtol=RTOL, atol=ATOL)
    # a pair distance moves by at most 2 sqrt(3) times the largest
    # coordinate difference, a score gap by twice the largest difference
    dist_moved = 2 * np.sqrt(3) * float(np.abs(ct - cj)[mj > 0.5].max())
    gap_moved = 2 * float(np.abs(ht - hj)[mj > 0.5].max())
    margin = perception_margin(cj, hj.argmax(-1), mj)
    gaps = type_margin(hj, mj)
    assert (margin > dist_moved).all() and (gaps > gap_moved).all(), (
        f"a probe sits within reach of a threshold: margins {margin} A "
        f"(forwards differ by up to {dist_moved:.2e}), type gaps {gaps} "
        f"({gap_moved:.2e})")
    np.testing.assert_array_equal(ht.argmax(-1), hj.argmax(-1))
    np.testing.assert_array_equal(rt, rj)
    _, t_norm = times(len(st[0]))
    with torch.no_grad():
        fed = spsa.spsa_update(
            v3b.core, v3b.eps, FixedRewards(rj), *tt(*st), tt(t_norm)[0],
            0.05, copy_cfg(tcfg.SPSAConfig, jc),
            noise=tt(spsa_draws(key, jc.num_probes, st[0][..., :3].shape))[0])
    close(fed[0], ref[0])
    close(fed[1], ref[1])
    close(out[0], ref[0])
    close(out[1], ref[1])


def test_spsa_draws_from_the_generator_when_no_noise_is_given(small):
    st = state([2, 3], seed=1)
    _, t_norm = times(2)
    cfg = tcfg.SPSAConfig(enabled=True, num_probes=2)
    outs = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(spsa.spsa_update(
                small.core, small.eps, small.oracle, *tt(*st),
                tt(t_norm)[0], 0.2, cfg, generator=g)[0])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError, match="noise has shape"):
        spsa.spsa_update(small.core, small.eps, small.oracle, *tt(*st),
                         tt(t_norm)[0], 0.2, cfg,
                         noise=torch.zeros(3, 2, 8, 3))


# ---------------------------------------------------------------------------
# ATP
# ---------------------------------------------------------------------------

def branch_draws(key, g_extra, shape):
    """[G-1, B, NL, D]: the step noise of atp_prune's branches."""
    k_branch, _ = jax.random.split(key)
    return np.stack([normal(bk, shape)
                     for bk in jax.random.split(k_branch, g_extra)])


def run_atp(pair, st, key, jc):
    s_norm, t_norm = times(len(st[0]))
    with torch.no_grad():
        ref = jatp.atp_prune(key, pair.jax_core, pair.jax_eps,
                             pair.jax_oracle, *map(jnp.asarray, st),
                             jnp.float32(s_norm[0]), jnp.float32(t_norm[0]),
                             jnp.asarray(S_STEP), jc)
        draws = branch_draws(key, jc.num_groups - 1, st[0].shape)
        out = atp.atp_prune(pair.core, pair.eps, pair.oracle, *tt(*st),
                            *tt(s_norm, t_norm), S_STEP,
                            copy_cfg(tcfg.ATPConfig, jc), noise=tt(draws)[0])
    return out, ref


def check_prune(out, ref):
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    close(out[0], ref[0])
    close(out[1], ref[1])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


@pytest.mark.parametrize("scope", [
    dict(), dict(group_size=2), dict(per_sample=True),
    dict(compat_precedence=False)],
    ids=["global", "group_size", "per_sample", "plain_precedence"])
def test_atp_prune_matches_jax(small, scope):
    st = state([0, 5, 7, 11], seed=3, sigma=0.12)
    jc = jcfg.ATPConfig(enabled=True, num_groups=3, **scope)
    out, ref = run_atp(small, st, jax.random.PRNGKey(21), jc)
    check_prune(out, ref)
    sel = out[4].numpy()
    if scope.get("per_sample"):
        np.testing.assert_array_equal(sel % 4, np.arange(4))
    if scope.get("group_size"):
        np.testing.assert_array_equal((sel % 4) // 2, [0, 0, 1, 1])


def test_atp_prune_matches_jax_on_v3b(v3b):
    st = state([0, 5], seed=4, sigma=0.12)
    jc = jcfg.ATPConfig(enabled=True, num_groups=3)
    check_prune(*run_atp(v3b, st, jax.random.PRNGKey(8), jc))


def test_atp_ties_keep_the_lower_index(small):
    """Every candidate of a noise state is invalid and scores 0, so the
    whole selection is a tie: the first B flat indices win, on both
    sides."""
    st = noise_state(4, 16, 32, seed=5)
    jc = jcfg.ATPConfig(enabled=True, num_groups=3)
    small.oracle.reset_counts()
    out, ref = run_atp(small, st, jax.random.PRNGKey(2), jc)
    assert small.oracle.invalid_rate == 1.0 and small.oracle.n_scored == 24
    np.testing.assert_array_equal(np.asarray(ref[4]), np.arange(4))
    check_prune(out, ref)


@pytest.mark.parametrize("rewards", ["random", "mostly_equal", "all_equal"])
@pytest.mark.parametrize("scope", [
    dict(), dict(group_size=4), dict(per_sample=True)],
    ids=["global", "group_size", "per_sample"])
def test_select_candidates_matches_jax(scope, rewards):
    rng = np.random.default_rng(0)
    b, g = 8, 5
    for _ in range(20):
        mixed = rng.normal(size=(g * b,)).astype(np.float32)
        if rewards == "mostly_equal":
            mixed[rng.uniform(size=mixed.shape) < 0.8] = 0.0
        elif rewards == "all_equal":
            mixed[:] = 0.25
        ref = jatp.select_candidates(jnp.asarray(mixed),
                                     jcfg.ATPConfig(**scope), b)
        out = atp.select_candidates(torch.from_numpy(mixed),
                                    tcfg.ATPConfig(**scope), b)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# the hybrid
# ---------------------------------------------------------------------------

def hybrid_draws(key, g_extra, k, shape):
    k_branch, _ = jax.random.split(key)
    branch, probes = [], []
    for bk in jax.random.split(k_branch, g_extra):
        k1, k2 = jax.random.split(bk)
        branch.append(normal(k1, shape))
        probes.append(spsa_draws(k2, k, shape[:2] + (3,)))
    return np.stack(branch), np.stack(probes)


@pytest.mark.parametrize("which", ["small", "v3b"])
def test_hybrid_spsa_prune_matches_jax(which, request):
    pair = request.getfixturevalue(which)
    rows = [0, 5, 7] if which == "small" else [0, 5]
    st = state(rows, seed=6, sigma=0.12)
    s_norm, t_norm = times(len(rows))
    ja = jcfg.ATPConfig(enabled=True, num_groups=4)
    js = jcfg.SPSAConfig(enabled=True, num_probes=2, zeta0=0.08)
    key = jax.random.PRNGKey(13)
    zeta = 0.03
    with torch.no_grad():
        ref = jatp.hybrid_spsa_prune(
            key, pair.jax_core, pair.jax_eps, pair.jax_oracle,
            *map(jnp.asarray, st), jnp.float32(s_norm[0]),
            jnp.float32(t_norm[0]), jnp.asarray(S_STEP), ja, js, zeta)
        branch, probes = hybrid_draws(key, 3, 2, st[0].shape)
        out = atp.hybrid_spsa_prune(
            pair.core, pair.eps, pair.oracle, *tt(*st), *tt(s_norm, t_norm),
            S_STEP, copy_cfg(tcfg.ATPConfig, ja),
            copy_cfg(tcfg.SPSAConfig, js), zeta, noise=tt(branch)[0],
            spsa_noise=tt(probes)[0])
    check_prune(out, ref)
