"""The port's joint model against the JAX package's (mode 'joint').

On the same weights (a small denoiser of the JAX init, converted by
``params_from_jax``) and the same inputs:

- ``remove_mean_joint`` and every ``JointDiffusion`` method, fed the
  draws JAX made from its key: rtol and atol 1e-5 (fp32, single
  functions);
- the denoiser with ``update_pocket_coords``: every row moves and the
  velocity has a zero joint centre of mass, against JAX's XLA path and
  its Pallas path in interpret mode (rtol 1e-4, atol 1e-5 as
  tests/test_torch_dynamics.py: two layers of sums in another order);
  the frozen-pocket path keeps the pocket still;
- ``get_repaint_schedule`` ``==`` JAX's over a grid;
- ``JointSampler.sample`` and ``.inpaint`` (resamplings 2, jump length
  2) replayed under JAX's noise, T = 8: coordinates within 1e-4 A and
  the same types;
- the joint size prior's tables, log-probabilities and entropy;
- the conditional sampler on the joint-mode denoiser (what a joint
  config's ``sample_given_pocket`` runs) replayed under JAX's noise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.diffusion import joint as jjoint  # noqa: E402
from diffndm_tpu.diffusion import node_distribution as jnd  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.ops import segment as jseg  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JBatch  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.diffusion import joint as tjoint  # noqa: E402
from diffndm_tpu_torch.diffusion import node_distribution as tnd  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.ops import segment as tseg  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from test_torch_dynamics import port_dynamics  # noqa: E402

T = 8
NF = 10
B, NL, NP = 2, 8, 16
FN_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-5)
PATH_ATOL = 1e-4        # Angstrom, a whole fixed-noise trajectory
EGNN = dict(hidden_nf=16, joint_nf=8, n_layers=2, attention=True, tanh=True,
            reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0,
            update_pocket_coords=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t2n(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def close(name, out, ref, **tol):
    np.testing.assert_allclose(t2n(out), np.asarray(ref), err_msg=name,
                               **(tol or FN_TOL))


def masks():
    lm = np.ones((B, NL), np.float32)
    lm[1, 5:] = 0
    pm = np.ones((B, NP), np.float32)
    pm[0, 13:] = 0
    return lm, pm


def inputs(seed=0):
    """Ligand and pocket batches (unnormalised: coordinates in A, one-hot
    types), the pocket about 3 A around the ligand."""
    rng = np.random.default_rng(seed)
    lm, pm = masks()
    x_l = rng.normal(size=(B, NL, 3)).astype(np.float32) * lm[..., None]
    x_p = (rng.normal(size=(B, NP, 3)) * 3).astype(np.float32) * \
        pm[..., None]
    h_l = np.eye(NF, dtype=np.float32)[rng.integers(0, 4, (B, NL))] * \
        lm[..., None]
    h_p = np.eye(NF, dtype=np.float32)[rng.integers(0, 4, (B, NP))] * \
        pm[..., None]
    return (x_l, h_l, lm), (x_p, h_p, pm)


def jax_batch(parts):
    return JBatch(*(jnp.asarray(a) for a in parts))


def torch_batch(parts):
    return NodeBatch(*(torch.from_numpy(a) for a in parts))


def jax_joint_draw(key, b, nl, npk, atom_nf=NF, residue_nf=NF):
    """The raw draws of JAX's sample_joint_noise(key): (ligand, pocket),
    coordinates then features."""
    kx, khl, khp = jax.random.split(key, 3)
    zx_l = jax.random.normal(kx, (b, nl, 3))
    zx_p = jax.random.normal(jax.random.fold_in(kx, 1), (b, npk, 3))
    zh_l = jax.random.normal(khl, (b, nl, atom_nf))
    zh_p = jax.random.normal(khp, (b, npk, residue_nf))
    return (torch.from_numpy(np.array(jnp.concatenate([zx_l, zh_l], -1))),
            torch.from_numpy(np.array(jnp.concatenate([zx_p, zh_p], -1))))


def jax_sample_draws(key, timesteps, shape):
    """The joint draws JAX's JointSampler.sample makes from ``key``, in
    the order the port consumes them."""
    key, k0 = jax.random.split(key)
    draws = [jax_joint_draw(k0, *shape)]
    for _ in range(timesteps):
        key, k = jax.random.split(key)
        draws.append(jax_joint_draw(k, *shape))
    key, kd = jax.random.split(key)
    draws.append(jax_joint_draw(kd, *shape))
    return draws


def jax_inpaint_draws(key, timesteps, resamplings, jump_length, shape):
    """The joint draws JAX's JointSampler.inpaint makes from ``key``:
    the initial z; per step the step's and the known part's; per jump
    one; the decode."""
    key, k0 = jax.random.split(key)
    draws = [jax_joint_draw(k0, *shape)]
    schedule = jjoint.get_repaint_schedule(resamplings, jump_length,
                                           timesteps)
    for i, n_steps in enumerate(schedule):
        for _ in range(n_steps):
            key, k = jax.random.split(key)
            k1, k2 = jax.random.split(k)
            draws += [jax_joint_draw(k1, *shape), jax_joint_draw(k2, *shape)]
        if i < len(schedule) - 1:
            key, k = jax.random.split(key)
            draws.append(jax_joint_draw(k, *shape))
    key, kd = jax.random.split(key)
    draws.append(jax_joint_draw(kd, *shape))
    return draws


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.EGNNConfig(**EGNN)
    module = JaxDynamics(jc, atom_nf=NF, residue_nf=NF)
    params = jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, NL, 13)),
        jnp.zeros((1, NP, 13)), jnp.zeros((1,)), jnp.ones((1, NL)),
        jnp.ones((1, NP)))
    dyn = port_dynamics(tcfg.EGNNConfig(**EGNN), NF, NF, params)
    jcore = jjoint.JointDiffusion(jS.make_schedule("polynomial_2", T, 5e-4),
                                  jcfg.DiffusionConfig(timesteps=T), NF, NF)
    tcore = tjoint.JointDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                                  tcfg.DiffusionConfig(timesteps=T), NF, NF)
    return dict(module=module, params=params, dyn=dyn, jcore=jcore,
                tcore=tcore, apply=jax.jit(module.apply))


def jeps(setup):
    return lambda zl, zp, t, lm, pm: setup["apply"](
        setup["params"], zl, zp, t, lm, pm)


def teps(setup):
    return lambda zl, zp, t, lm, pm: setup["dyn"](zl, zp, t, lm, pm)


def test_remove_mean_joint_equals_jax():
    rng = np.random.default_rng(1)
    lm, pm = masks()
    x_l = rng.normal(size=(B, NL, 3)).astype(np.float32)
    x_p = rng.normal(size=(B, NP, 3)).astype(np.float32) + 2.0
    ref = jseg.remove_mean_joint(*(jnp.asarray(a) for a in (x_l, x_p, lm,
                                                           pm)))
    out = tseg.remove_mean_joint(*(torch.from_numpy(a) for a in (x_l, x_p,
                                                                 lm, pm)))
    for o, r in zip(out, ref):
        close("remove_mean_joint", o, r)
    total = (t2n(out[0]).sum(1) + t2n(out[1]).sum(1))
    np.testing.assert_allclose(total, 0.0, atol=1e-5)
    assert not t2n(out[0])[1, 5:].any() and not t2n(out[1])[0, 13:].any()


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_joint_dynamics_forward_equals_jax(setup, pallas):
    (x_l, h_l, lm), (x_p, h_p, pm) = inputs(2)
    xh_l = np.concatenate([x_l, h_l / 4], -1)
    xh_p = np.concatenate([x_p, h_p / 4], -1)
    t = np.array([0.2, 0.7], np.float32)
    jc = dataclasses.replace(jcfg.EGNNConfig(**EGNN), use_pallas=pallas,
                             pallas_interpret=pallas)
    ref = JaxDynamics(jc, atom_nf=NF, residue_nf=NF).apply(
        setup["params"], *(jnp.asarray(a) for a in (xh_l, xh_p, t, lm, pm)))
    with torch.no_grad():
        out = setup["dyn"](*(torch.from_numpy(a)
                             for a in (xh_l, xh_p, t, lm, pm)))
    for name, o, r in zip(("eps_lig", "eps_pocket"), out, ref):
        close(name, o, r, **NET_TOL)
    # the pocket moves, and the velocity has no joint centre of mass
    vel_p = t2n(out[1])[..., :3]
    assert np.abs(vel_p).max() > 1e-6
    com = t2n(out[0])[..., :3].sum(1) + vel_p.sum(1)
    np.testing.assert_allclose(com, 0.0, atol=1e-6)


def test_frozen_pocket_path_keeps_pocket_still(setup):
    """With update_pocket_coords off, the same weights give the JAX
    conditional denoiser's output and a zero pocket velocity."""
    (x_l, h_l, lm), (x_p, h_p, pm) = inputs(3)
    xh_l = np.concatenate([x_l, h_l / 4], -1)
    xh_p = np.concatenate([x_p, h_p / 4], -1)
    t = np.array([0.4, 0.9], np.float32)
    cond = dict(EGNN, update_pocket_coords=False)
    ref = JaxDynamics(jcfg.EGNNConfig(**cond), atom_nf=NF,
                      residue_nf=NF).apply(
        setup["params"], *(jnp.asarray(a) for a in (xh_l, xh_p, t, lm, pm)))
    dyn = port_dynamics(tcfg.EGNNConfig(**cond), NF, NF, setup["params"])
    with torch.no_grad():
        out = dyn(*(torch.from_numpy(a) for a in (xh_l, xh_p, t, lm, pm)))
    for name, o, r in zip(("eps_lig", "eps_pocket"), out, ref):
        close(name, o, r, **NET_TOL)
    assert not t2n(out[1])[..., :3].any()


def test_joint_diffusion_methods_equal_jax(setup):
    jcore, tcore = setup["jcore"], setup["tcore"]
    lig, poc = inputs(4)
    jl, jp = jax_batch(lig), jax_batch(poc)
    tl, tp = torch_batch(lig), torch_batch(poc)
    lm, pm = jl.mask, jp.mask
    tlm, tpm = tl.mask, tp.mask
    shape = (B, NL, NP)

    xh_l = jcore.normalize_xh(jl.xh, lm, NF)
    xh_p = jcore.normalize_xh(jp.xh, pm, NF)
    t_xh_l = tcore.normalize_xh(torch.cat([tl.x, tl.h], -1), tlm)
    t_xh_p = tcore.normalize_xh(torch.cat([tp.x, tp.h], -1), tpm)
    close("normalize_xh", t_xh_l, xh_l)
    close("unnormalize_xh", tcore.unnormalize_xh(t_xh_p, tpm),
          jcore.unnormalize_xh(xh_p, pm))

    key = jax.random.PRNGKey(5)
    draw = jax_joint_draw(key, *shape)
    for o, r in zip(tcore.sample_joint_noise(tlm, tpm, draw),
                    jcore.sample_joint_noise(key, lm, pm)):
        close("sample_joint_noise", o, r)

    gamma_t = jcore.schedule(jnp.array([0.25, 0.75]))
    t_gamma_t = tcore.schedule(torch.tensor([0.25, 0.75]))
    close("gamma", t_gamma_t, gamma_t)
    ref = jcore.noised_representation(key, xh_l, xh_p, lm, pm, gamma_t)
    out = tcore.noised_representation(t_xh_l, t_xh_p, tlm, tpm, t_gamma_t,
                                      draw)
    for o, r in zip(out, ref):
        close("noised_representation", o, r)
    jz_l, jz_p = ref[:2]
    tz_l, tz_p = out[:2]

    k2 = jax.random.PRNGKey(6)
    d2 = jax_joint_draw(k2, *shape)
    s_n, t_n = jnp.float32(3) / T, jnp.float32(4) / T
    for fix in (False, True):
        ref = jcore.sample_p_zs_given_zt(k2, s_n, t_n, jz_l, jz_p, lm, pm,
                                         jeps(setup), fix_noise=fix)
        with torch.no_grad():
            out = tcore.sample_p_zs_given_zt(
                torch.full((B,), 3.0) / T, torch.full((B,), 4.0) / T, tz_l,
                tz_p, tlm, tpm, teps(setup), fix_noise=fix, noise=d2)
        for o, r in zip(out, ref):
            close(f"sample_p_zs_given_zt fix={fix}", o, r)

    g_t = jcore.schedule(jnp.full((B,), 5.0 / T))
    g_s = jcore.schedule(jnp.full((B,), 3.0 / T))
    ref = jcore.sample_p_zt_given_zs(k2, jz_l, jz_p, lm, pm, g_t, g_s)
    out = tcore.sample_p_zt_given_zs(tz_l, tz_p, tlm, tpm,
                                     tcore.schedule(torch.full((B,), 5 / T)),
                                     tcore.schedule(torch.full((B,), 3 / T)),
                                     d2)
    for o, r in zip(out, ref):
        close("sample_p_zt_given_zs", o, r)

    for fix in (False, True):
        ref = jcore.sample_p_xh_given_z0(k2, jz_l, jz_p, lm, pm, jeps(setup),
                                         fix_noise=fix)
        with torch.no_grad():
            out = tcore.sample_p_xh_given_z0(tz_l, tz_p, tlm, tpm,
                                             teps(setup), fix_noise=fix,
                                             noise=d2)
        for o, r in zip(out, ref):
            close(f"sample_p_xh_given_z0 fix={fix}", o, r)


def test_repaint_schedule_equals_jax():
    for timesteps in (1, 5, 8, 10, 37, 50, 500):
        for resamplings in (1, 2, 3, 10):
            for jump_length in (1, 2, 3, 10, 60):
                args = (resamplings, jump_length, timesteps)
                ref = jjoint.get_repaint_schedule(*args)
                assert tjoint.get_repaint_schedule(*args) == ref, args
                assert tjoint.count_joint_forwards(
                    timesteps, resamplings, jump_length) == sum(ref) + 1
    assert tjoint.count_joint_forwards(500, 2, 10) == 991
    assert tjoint.count_joint_forwards(500) == 501


def test_joint_sample_replays_jax(setup):
    jcore, tcore = setup["jcore"], setup["tcore"]
    sampler_j = jjoint.JointSampler(jcore, setup["module"], setup["params"])
    sampler_t = tjoint.JointSampler(tcore, setup["dyn"])
    n_lig, n_poc = np.array([5, 8]), np.array([13, 16])
    key = jax.random.PRNGKey(7)
    jl, jp = sampler_j.sample(key, n_lig, n_poc, lig_pad=8, pocket_pad=16)
    draws = jax_sample_draws(key, T, (B, NL, NP))
    assert len(draws) == tjoint.count_joint_draws(T)
    tl, tp = sampler_t.sample(n_lig, n_poc, lig_pad=8, pocket_pad=16,
                              noise=draws)
    for name, o, r in (("ligand x", tl.x, jl.x), ("pocket x", tp.x, jp.x)):
        close(name, o, r, rtol=0, atol=PATH_ATOL)
    for o, r in ((tl.h, jl.h), (tp.h, jp.h), (tl.mask, jl.mask),
                 (tp.mask, jp.mask)):
        np.testing.assert_array_equal(t2n(o), np.asarray(r))
    com = t2n(tl.x).sum(1) + t2n(tp.x).sum(1)
    np.testing.assert_allclose(com, 0.0, atol=1e-4)
    # a generator draws instead: finite, the same shapes
    gl, gp = sampler_t.sample(n_lig, n_poc, lig_pad=8, pocket_pad=16,
                              generator=torch.Generator().manual_seed(0))
    assert gl.x.shape == tl.x.shape and bool(torch.isfinite(gp.x).all())
    with pytest.raises(ValueError, match="joint draws"):
        sampler_t.sample(n_lig, n_poc, noise=draws[:-1])


def test_joint_inpaint_replays_jax(setup):
    """The whole pocket and two ligand atoms fixed, resamplings 2, jump
    length 2 (jumps between runs)."""
    jcore, tcore = setup["jcore"], setup["tcore"]
    lig, poc = inputs(8)
    lig_fixed = np.zeros((B, NL), np.float32)
    lig_fixed[:, :2] = 1
    poc_fixed = poc[2].copy()
    key = jax.random.PRNGKey(9)
    sampler_j = jjoint.JointSampler(jcore, setup["module"], setup["params"])
    jl, jp = sampler_j.inpaint(key, jax_batch(lig), jax_batch(poc),
                               lig_fixed, poc_fixed, resamplings=2,
                               jump_length=2)
    assert len(jjoint.get_repaint_schedule(2, 2, T)) > 1
    draws = jax_inpaint_draws(key, T, 2, 2, (B, NL, NP))
    assert len(draws) == tjoint.count_joint_draws(T, 2, 2, inpaint=True)
    tl, tp = tjoint.JointSampler(tcore, setup["dyn"]).inpaint(
        torch_batch(lig), torch_batch(poc), torch.from_numpy(lig_fixed),
        torch.from_numpy(poc_fixed), resamplings=2, jump_length=2,
        noise=draws)
    for name, o, r in (("ligand x", tl.x, jl.x), ("pocket x", tp.x, jp.x)):
        close(name, o, r, rtol=0, atol=PATH_ATOL)
    np.testing.assert_array_equal(t2n(tl.h), np.asarray(jl.h))
    np.testing.assert_array_equal(t2n(tp.h), np.asarray(jp.h))
    # the fixed pocket keeps its internal geometry
    m = poc[2][0] > 0
    din = poc[0][0][m]
    dout = t2n(tp.x)[0][m]
    dd = (np.linalg.norm(din[:, None] - din[None], axis=-1)
          - np.linalg.norm(dout[:, None] - dout[None], axis=-1))
    assert np.abs(dd).max() < 1.0


def test_size_prior_equals_jax():
    hist = jnd.default_histogram(max_lig=20, max_pocket=60)
    ref = jnd.DistributionNodes(hist)
    out = tnd.DistributionNodes(tnd.default_histogram(max_lig=20,
                                                      max_pocket=60))
    close("prob", out.prob, ref.prob)
    close("log_prob_table", out.log_prob_table, ref.log_prob_table)
    assert out.entropy == pytest.approx(ref.entropy, rel=1e-6)
    n1 = np.array([6, 10, 20, 3])
    n2 = np.array([0, 30, 60, 45])
    close("log_prob", out.log_prob(n1, n2), ref.log_prob(n1, n2))
    close("log_prob_n1_given_n2", out.log_prob_n1_given_n2(n1, n2),
          ref.log_prob_n1_given_n2(n1, n2))
    close("log_prob_n2_given_n1", out.log_prob_n2_given_n1(n2, n1),
          ref.log_prob_n2_given_n1(n2, n1))
    # joint draws: inside the table, and they follow its density
    a, b = out.sample(4000, generator=torch.Generator().manual_seed(0))
    assert a.shape == b.shape == (4000,)
    assert a.max() <= 20 and b.max() <= 60
    emp = np.zeros(out.prob.shape)
    np.add.at(emp, (a, b), 1.0 / len(a))
    assert np.abs(emp.sum(1) - t2n(out.prob).sum(1)).max() < 0.03


def test_conditional_sampling_on_the_joint_denoiser_replays_jax(setup):
    """A joint config's conditional entry points run the conditional
    sampler on the joint-mode denoiser (pocket velocities computed and
    discarded), as the JAX package does: T = 8, JAX's noise fed in."""
    from diffndm_tpu.constants import dataset_params
    from diffndm_tpu.diffusion.core import CondDiffusion as JCond
    from diffndm_tpu.diffusion.sampler import ConditionalSampler as JSampler
    from diffndm_tpu_torch.diffusion.core import CondDiffusion as TCond
    from diffndm_tpu_torch.diffusion.sampler import ConditionalSampler
    from test_torch_sampler import jax_noise

    _, poc = inputs(10)
    sizes = np.array([5, 8])
    jcore = JCond(jS.make_schedule("polynomial_2", T, 5e-4),
                  jcfg.DiffusionConfig(timesteps=T), NF, NF)
    tcore = TCond(tS.make_schedule("polynomial_2", T, 5e-4),
                  tcfg.DiffusionConfig(timesteps=T), NF, NF)
    sampler = JSampler(jcore, setup["module"], setup["params"],
                       jcfg.SampleConfig(), dataset_params["crossdock_full"])
    key = jax.random.PRNGKey(12)
    ref = sampler.sample_given_pocket(key, jax_batch(poc), sizes)
    nl = ref.ligand.x.shape[1]
    out = ConditionalSampler(tcore, setup["dyn"],
                             tcfg.SampleConfig()).sample_given_pocket(
        torch_batch(poc), sizes,
        noise=jax_noise(key, (B, nl, 3 + NF), T))
    for name, o, r in (("ligand x", out.ligand.x, ref.ligand.x),
                       ("pocket x", out.pocket.x, ref.pocket.x)):
        close(name, o, r, rtol=0, atol=PATH_ATOL)
    np.testing.assert_array_equal(t2n(out.ligand.h), np.asarray(ref.ligand.h))
    # the pocket stays where it was: its velocity was discarded
    close("pocket kept", out.pocket.x, poc[0], rtol=0, atol=1e-4)
