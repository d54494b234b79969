"""The port's diffusion math against the JAX package.

Schedule tables are float64 numpy computations stored as float32 and
must be equal.  The sampling functions are fed the noise JAX drew from
its keys and a denoiser that both sides evaluate the same way; they
agree to rtol 1e-5, atol 1e-6 (fp32, with transcendental functions
of two libraries that may differ in the last bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu.config import DiffusionConfig as JDiffusionConfig  # noqa: E402
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion import node_distribution as jnd  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu_torch.config import DiffusionConfig  # noqa: E402
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import node_distribution as tnd  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
ATOM_NF = 10
B, NL, NP = 3, 8, 16


@pytest.mark.parametrize("name,T,precision", [
    ("polynomial_2", 500, 5e-4), ("polynomial_3", 100, 1e-4),
    ("cosine", 200, 1e-4)])
def test_schedule_tables_equal(name, T, precision):
    js = jS.make_schedule(name, T, precision)
    ts = tS.make_schedule(name, T, precision)
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    t = np.linspace(0.0, 1.0, 37, dtype=np.float32)
    np.testing.assert_array_equal(ts(torch.from_numpy(t)).numpy(),
                                  np.asarray(js(jnp.asarray(t))))
    steps = np.array([0, 1, T // 2, T, T + 5])
    np.testing.assert_array_equal(ts.at_step(torch.from_numpy(steps)).numpy(),
                                  np.asarray(js.at_step(jnp.asarray(steps))))


def test_clip_and_transition_coefficients():
    a2 = np.linspace(1.0, 0.0, 50) ** 2
    np.testing.assert_array_equal(tS.clip_noise_schedule(a2),
                                  jS.clip_noise_schedule(a2))
    table = jS.make_schedule("polynomial_2", 500, 5e-4).table
    gt, gs = table[1:], table[:-1]
    ref = jS.sigma_and_alpha_t_given_s(gt, gs)
    out = tS.sigma_and_alpha_t_given_s(T(gt), T(gs))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


def test_check_norm_values():
    ts = tS.make_schedule("polynomial_2", 500, 5e-4)
    tS.check_norm_values(ts, 4.0)
    js = jS.make_schedule("polynomial_2", 500, 5e-1)
    with pytest.raises(ValueError):
        jS.check_norm_values(js, 4.0)
    with pytest.raises(ValueError):
        tS.check_norm_values(tS.make_schedule("polynomial_2", 500, 5e-1),
                             4.0)


def eps_fn_factory(lib):
    """A fixed smooth stand-in for the denoiser, written once per
    library: eps_lig = tanh(z * (1 + t)) + 0.1 * pocket COM."""
    def fn(z, xh_p, t, lm, pm):
        com = lib.mean(xh_p[..., :3], 1)[:, None, :]
        pad = lib.zeros_like(z[..., 3:])
        shift = lib.concatenate([com, pad[:, :1]], -1) if lib is jnp else \
            torch.cat([com, pad[:, :1]], -1)
        out = lib.tanh(z * (1.0 + t.reshape(-1, 1, 1))) + 0.1 * shift
        return out * lm[..., None], xh_p
    return fn


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)
    lm = np.ones((B, NL), np.float32)
    lm[1, 6:] = 0
    lm[2, 4:] = 0
    pm = np.ones((B, NP), np.float32)
    pm[0, 12:] = 0
    z = rng.normal(size=(B, NL, 3 + ATOM_NF)).astype(np.float32) * \
        lm[..., None]
    xh_p = rng.normal(size=(B, NP, 3 + ATOM_NF)).astype(np.float32) * \
        pm[..., None]
    jc = jcore.CondDiffusion(jS.make_schedule("polynomial_2", 500, 5e-4),
                             JDiffusionConfig(), ATOM_NF, ATOM_NF)
    tc = tcore.CondDiffusion(tS.make_schedule("polynomial_2", 500, 5e-4),
                             DiffusionConfig(), ATOM_NF, ATOM_NF)
    return dict(z=z, xh_p=xh_p, lm=lm, pm=pm, jc=jc, tc=tc)


def T(a):
    return torch.from_numpy(np.array(a))


def close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_normalize_and_unnormalize(state):
    cfg = dict(norm_values=(1.0, 4.0), norm_biases=(0.0, 0.5))
    jc = state["jc"]._replace(cfg=JDiffusionConfig(**cfg))
    tc = tcore.CondDiffusion(state["tc"].schedule, DiffusionConfig(**cfg),
                             ATOM_NF, ATOM_NF)
    for fn in ("normalize_xh", "unnormalize_xh"):
        close(getattr(tc, fn)(T(state["z"]), T(state["lm"])),
              getattr(jc, fn)(state["z"], state["lm"]))


def test_sample_p_zs_given_zt_with_jax_noise(state):
    key = jax.random.PRNGKey(5)
    s = np.full((B,), 41 / 500, np.float32)
    t = np.full((B,), 42 / 500, np.float32)
    z_s, xh_p, _, _ = state["jc"].sample_p_zs_given_zt(
        key, jnp.asarray(s), jnp.asarray(t), state["z"], state["xh_p"],
        state["lm"], state["pm"], eps_fn_factory(jnp))
    noise = jax.random.normal(key, state["z"].shape, jnp.float32)
    tz_s, txh_p = state["tc"].sample_p_zs_given_zt(
        T(s), T(t), T(state["z"]), T(state["xh_p"]), T(state["lm"]),
        T(state["pm"]), eps_fn_factory(torch), noise=T(noise))
    close(tz_s, z_s)
    close(txh_p, xh_p)


def test_to_x0(state):
    t = np.full((B,), 0.3, np.float32)
    ref = state["jc"].to_x0(state["z"], state["xh_p"], jnp.asarray(t),
                            state["lm"], state["pm"], eps_fn_factory(jnp))
    out = state["tc"].to_x0(T(state["z"]), T(state["xh_p"]), T(t),
                            T(state["lm"]), T(state["pm"]),
                            eps_fn_factory(torch))
    close(out, ref)


def test_sample_p_xh_given_z0_with_jax_noise(state):
    key = jax.random.PRNGKey(9)
    ref = state["jc"].sample_p_xh_given_z0(
        key, state["z"], state["xh_p"], state["lm"], state["pm"],
        eps_fn_factory(jnp))
    noise = jax.random.normal(key, state["z"].shape, jnp.float32)
    out = state["tc"].sample_p_xh_given_z0(
        T(state["z"]), T(state["xh_p"]), T(state["lm"]), T(state["pm"]),
        eps_fn_factory(torch), noise=T(noise))
    for o, r in zip(out, ref):
        close(o, r)


def test_init_ligand_from_pocket_with_jax_noise(state):
    key = jax.random.PRNGKey(2)
    px, ph = state["xh_p"][..., :3], state["xh_p"][..., 3:]
    ref = jcore.init_ligand_from_pocket(key, state["jc"], px, ph,
                                        state["lm"], state["pm"])
    noise = jax.random.normal(key, (B, NL, 3 + ATOM_NF), jnp.float32)
    out = tcore.init_ligand_from_pocket(state["tc"], T(px), T(ph),
                                        T(state["lm"]), T(state["pm"]),
                                        noise=T(noise))
    for o, r in zip(out, ref):
        close(o, r)


def test_noise_shape_is_checked(state):
    with pytest.raises(ValueError, match="noise has shape"):
        tcore.draw_noise(T(state["z"]), torch.zeros(1, 2), None)


def test_node_distribution_tables_match():
    hist = np.load("data/processed/virtual_v3/size_distribution.npy")
    for h in (hist, jnd.default_histogram()):
        j, t = jnd.DistributionNodes(h), tnd.DistributionNodes(h)
        np.testing.assert_array_equal(t.prob.numpy(), np.asarray(j.prob))
        np.testing.assert_array_equal(t.log_n1_given_n2.numpy(),
                                      np.asarray(j._log_n1_given_n2))
    np.testing.assert_array_equal(tnd.default_histogram(),
                                  jnd.default_histogram())


def test_size_sampling_follows_the_conditional():
    """Draws from the port's generator follow p(N_lig | N_pocket): the
    empirical frequencies of 20000 draws lie within 0.02 of the table."""
    hist = np.load("data/processed/virtual_v3/size_distribution.npy")
    dist = tnd.DistributionNodes(hist)
    n2 = int(np.argmax(hist.sum(0)))
    g = torch.Generator().manual_seed(0)
    draws = dist.sample_conditional(np.full(20000, n2), g)
    p = torch.exp(dist.log_n1_given_n2[:, n2]).numpy()
    freq = np.bincount(draws, minlength=len(p)) / len(draws)
    assert np.abs(freq - p).max() < 0.02
