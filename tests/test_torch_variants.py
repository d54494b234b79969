"""The port's model variants against the JAX package's, on the dense chain
that JAX runs for them (its row-tiled path; ``use_pallas`` off).

- ``EGNNDynamics`` forward, small width (hidden 32, 2 layers, B = 2 with
  padded ligand and pocket rows), weights converted from a JAX tree
  (``jax_params``):
  {sinusoid distance embedding, ``mean`` aggregation, the edge-type
  embedding, all three, the GNN denoiser, the GNN with the edge-type
  embedding} x {conditional, joint}, within atol 1e-5 + rtol 1e-4 (two
  layers of fp32 sums taken in another order).
- The gradient of a weighted sum of the all-three variant's outputs with
  respect to every parameter against ``jax.grad``: each tensor within
  1e-5 + 1e-4 of its largest entry.
- ``pocket_conditioning_simple``: ``conditional_loss_terms`` given JAX's
  draws, and a T = 10 sampler replay under the noise of JAX's key
  schedule, within 1e-4.
- The converter carries the edge-type embedding and the ``gnn`` tree both
  ways, and a reference state dict's ``dynamics.edge_embedding.weight``
  as JAX's ``convert_state_dict`` does.
- The variants the port used to refuse are no longer routed through the
  kernels: the dense chain runs exactly where JAX's condition says.

The JAX package's sinusoid path hands ``sinusoid_embed`` the squared
distances without their trailing feature axis ([B, T, N] against the
[6] frequencies: a broadcasting error at any N but 6, so JAX cannot run
the variant as it stands).  The reference embeds each distance on its own
(egnn_new.py:282-293, a [E, 1] column times the frequencies), and so does
the port; here JAX's own ``sinusoid_embed`` is called with the axis
restored (``jax_sin_axis``), which is that semantics.  And JAX's GNN
without extra edge features cannot build: flax's lecun_normal divides by
the fan-in of its empty [0, H] edge kernels while shaping them, so its
GCL initializer is given an empty branch here (the kernel holds no
number either way).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jparams  # noqa: E402
from diffndm_tpu.data.dataset import (  # noqa: E402
    ProcessedLigandPocketDataset as JDataset, collate_padded as jcollate)
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.sampler import \
    ConditionalSampler as JSampler  # noqa: E402
from diffndm_tpu.models import egnn as jegnn  # noqa: E402
from diffndm_tpu.models import dynamics as jdynamics  # noqa: E402
from diffndm_tpu.train import losses as jlosses  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import (convert_state_dict,  # noqa: E402
                                       params_from_jax, params_to_jax)
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.diffusion.sampler import (  # noqa: E402
    ConditionalSampler as TSampler, SamplerNoise)
from diffndm_tpu_torch.models import egnn as tegnn  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NF = 10
B, NL, NP = 2, 9, 14
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
VARIANTS = {
    "sin": dict(sin_embedding=True),
    "mean": dict(aggregation_method="mean"),
    "edge_emb": dict(edge_embedding_dim=4),
    "all_three": dict(sin_embedding=True, aggregation_method="mean",
                      edge_embedding_dim=4),
    "gnn": dict(mode="gnn_dynamics"),
    "gnn_edge_emb": dict(mode="gnn_dynamics", edge_embedding_dim=4),
}
MODES = {"conditional": False, "joint": True}


@pytest.fixture(scope="module", autouse=True)
def jax_sin_axis():
    """For this module's JAX runs: JAX's sinusoid_embed given each squared
    distance as a [..., 1] column, and JAX's GCL initializer able to shape
    an empty [0, H] kernel.  Yields JAX's own sinusoid_embed."""
    embed, init = jegnn.sinusoid_embed, jegnn._default_init

    def init_or_empty(key, shape, dtype=jnp.float32):
        return (jnp.zeros(shape, dtype) if 0 in shape
                else init(key, shape, dtype))

    patch = pytest.MonkeyPatch()
    patch.setattr(jegnn, "sinusoid_embed",
                  lambda d2, *args, **kw: embed(d2[..., None], *args, **kw))
    patch.setattr(jegnn, "_default_init", init_or_empty)
    yield embed
    patch.undo()


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def inputs():
    """B = 2 complexes: 9 and 6 ligand atoms, 12 and 14 pocket atoms,
    about 3 A apart so that the 5 A cutoffs keep some edges and drop
    others."""
    rng = np.random.default_rng(0)
    lm = np.ones((B, NL), np.float32)
    lm[1, 6:] = 0
    pm = np.ones((B, NP), np.float32)
    pm[0, 12:] = 0
    xl = np.concatenate([rng.normal(size=(B, NL, 3)) * 1.5,
                         rng.normal(size=(B, NL, NF))], -1)
    xp = np.concatenate([rng.normal(size=(B, NP, 3)) * 3.0,
                         rng.normal(size=(B, NP, NF))], -1)
    t = np.array([0.2, 0.8], np.float32)
    return (xl.astype(np.float32) * lm[..., None],
            xp.astype(np.float32) * pm[..., None], t, lm, pm)


@functools.lru_cache(maxsize=None)
def jax_params(variant):
    """A JAX parameter tree of the variant (conditional and joint mode
    share it): flax's shapes (``jax.eval_shape`` of the init, which
    compiles nothing) filled from a numpy seed, kernels at 1/sqrt(fan-in)
    (the coordinate updates' last at flax's 1e-3 of it) and biases
    non-zero, so that every term of the chain carries weight."""
    module = jdynamics.EGNNDynamics(
        jcfg.EGNNConfig(**EGNN, **VARIANTS.get(variant, {})), atom_nf=NF,
        residue_nf=NF)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(3),
                            jnp.zeros((1, 8, 3 + NF)),
                            jnp.zeros((1, 16, 3 + NF)), jnp.zeros((1,)),
                            jnp.ones((1, 8)), jnp.ones((1, 16)))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = str(path[-1].key)
        scale = (0.1 if name.endswith("bias") or name == "embedding"
                 else 1.0 / np.sqrt(max(leaf.shape[0], 1)))
        if name.endswith("_out_kernel"):
            # the coordinate updates' last layer at flax's gain of 1e-3:
            # larger steps move the second layer's distances enough that
            # the sinusoid's top frequency (429 rad per A) turns fp32
            # rounding of the coordinates into 1e-4-level features
            scale *= 1e-3
        return jnp.asarray((rng.normal(size=leaf.shape) * scale).astype(
            np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)     # one JAX compile per case
def case(variant, mode):
    """(JAX module, its params, the jitted apply, the port's dynamics on
    the same weights)."""
    kw = dict(EGNN, **VARIANTS[variant], update_pocket_coords=MODES[mode])
    module = jdynamics.EGNNDynamics(jcfg.EGNNConfig(**kw), atom_nf=NF,
                                    residue_nf=NF)
    params = jax_params(variant)
    dyn = EGNNDynamics(tcfg.EGNNConfig(**kw), NF, NF)
    dyn.load_state_dict(params_from_jax(params), strict=True)
    return module, params, jax.jit(module.apply), dyn.eval()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dynamics_forward_equals_jax(variant, mode):
    module, params, apply, dyn = case(variant, mode)
    args = inputs()
    ref = apply(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        out = dyn(*(torch.from_numpy(a) for a in args))
    for name, o, r in zip(("lig", "pocket"), out, ref):
        assert np.all(np.isfinite(o.numpy()))
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{variant} {name}")
    if MODES[mode]:
        # joint mode: the velocities have zero centre of mass over both
        vel = torch.cat([out[0][..., :3], out[1][..., :3]], 1)
        assert float(vel.sum(1).abs().max()) < 1e-5


def test_dynamics_gradient_equals_jax_grad():
    module, params, _, dyn = case("all_three", "conditional")
    args = inputs()
    rng = np.random.default_rng(1)
    wl = rng.normal(size=args[0].shape).astype(np.float32)
    wp = rng.normal(size=args[1].shape).astype(np.float32)

    def jloss(p):
        el, ep = module.apply(p, *(jnp.asarray(a) for a in args))
        return jnp.sum(el * wl) + jnp.sum(ep * wp)

    jgrads = flat(jax.jit(jax.grad(jloss))(params))
    dyn.zero_grad()
    el, ep = dyn(*(torch.from_numpy(a) for a in args))
    ((el * torch.from_numpy(wl)).sum()
     + (ep * torch.from_numpy(wp)).sum()).backward()
    ours = params_to_jax({n: (torch.zeros_like(p) if p.grad is None
                              else p.grad)
                          for n, p in dyn.named_parameters()})
    assert sorted(ours) == sorted(jgrads)
    for k, r in jgrads.items():
        err = float(np.abs(ours[k] - r).max())
        assert err <= 1e-5 + 1e-4 * float(np.abs(r).max()), (k, err)
    # the edge-type embedding and every layer receive a gradient
    assert float(np.abs(ours["params/edge_embedding/embedding"]).max()) > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_chain_runs_where_jax_leaves_its_kernels(variant, monkeypatch):
    """No variant reaches a kernel wrapper or a kernel's plain version
    (the dense chain is its own code); v3b's own configuration reaches
    both wrappers, once per layer."""
    calls = []
    originals = {n: getattr(K, n) for n in (
        "gcl_messages", "edge_vector_reduce", "edge_vector_reduce_pair",
        "gcl_messages_plain", "edge_vector_reduce_plain",
        "edge_vector_reduce_pair_plain")}

    def recorder(name):
        def fn(*args, **kw):
            calls.append(name)
            return originals[name](*args, **kw)
        return fn

    for name in originals:
        monkeypatch.setattr(K, name, recorder(name))
    _, _, _, dyn = case(variant, "conditional")
    with torch.no_grad():
        dyn(*(torch.from_numpy(a) for a in inputs()))
    assert calls == []
    if dyn.cfg.mode == "egnn_dynamics":
        assert not dyn.egnn.kernels
    plain = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF).eval()
    with torch.no_grad():
        plain(*(torch.from_numpy(a) for a in inputs()))
    assert [c for c in calls if not c.endswith("_plain")] == [
        "gcl_messages", "edge_vector_reduce_pair"] * EGNN["n_layers"]


def test_sinusoid_embedding_equals_jax(jax_sin_axis):
    d2 = np.random.default_rng(2).uniform(0, 60, size=(3, 5, 5)).astype(
        np.float32)
    assert tegnn.sinusoid_dims() == jegnn.sinusoid_dims() == 12
    out = tegnn.sinusoid_embed(torch.from_numpy(d2))
    ref = jax_sin_axis(jnp.asarray(d2)[..., None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["edge_emb", "gnn_edge_emb"])
def test_converter_round_trips_embedding_and_gnn_trees(variant):
    _, params, _, dyn = case(variant, "conditional")
    ref = {"params/" + k.split("/", 1)[1]: v for k, v in flat(params).items()}
    ours = params_to_jax(dyn.state_dict())
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    state = dyn.state_dict()
    assert state["edge_embedding.weight"].shape == (3, 4)
    np.testing.assert_array_equal(
        state["edge_embedding.weight"].numpy(),
        ref["params/edge_embedding/embedding"])
    if variant.startswith("gnn"):
        assert "params/gnn/gcl_0/edge_edge_kernel" in ours
        assert ours["params/gnn/gcl_0/edge_edge_kernel"].shape == (4, 32)


def test_reference_edge_embedding_converts_as_jax():
    from diffndm_tpu.convert import convert_state_dict as jconvert

    cfg = dataclasses.replace(
        tcfg.ModelConfig(atom_nf=NF, residue_nf=NF),
        egnn=tcfg.EGNNConfig(**dict(EGNN, edge_embedding_dim=4)))
    jc = jcfg.ModelConfig(atom_nf=NF, residue_nf=NF,
                          egnn=jcfg.EGNNConfig(**dict(EGNN,
                                                      edge_embedding_dim=4)))
    # a reference state dict: the split first edge layers joined back
    _, _, _, dyn = case("edge_emb", "conditional")
    sd = {}
    for name in ("atom_encoder", "atom_decoder", "residue_encoder",
                 "residue_decoder"):
        for i, idx in ((0, 0), (1, 2)):
            lin = getattr(dyn, f"{name}_l{i}")
            sd[f"dynamics.{name}.{idx}.weight"] = lin.weight.detach().numpy()
            sd[f"dynamics.{name}.{idx}.bias"] = lin.bias.detach().numpy()
    eg = dyn.egnn
    for part in ("embedding", "embedding_out"):
        lin = getattr(eg, part)
        sd[f"dynamics.egnn.{part}.weight"] = lin.weight.detach().numpy()
        sd[f"dynamics.egnn.{part}.bias"] = lin.bias.detach().numpy()
    for bi in range(EGNN["n_layers"]):
        blk = getattr(eg, f"e_block_{bi}")
        g = blk.gcl_0
        p = f"dynamics.egnn.e_block_{bi}"

        def joined(m, pre):
            w = torch.cat([getattr(m, f"{pre}_src_kernel"),
                           getattr(m, f"{pre}_dst_kernel"),
                           getattr(m, f"{pre}_edge_kernel")]).T
            return w.detach().numpy(), getattr(
                m, f"{pre}_dst_bias").detach().numpy()

        w, b = joined(g, "edge")
        sd.update({f"{p}.gcl_0.edge_mlp.0.weight": w,
                   f"{p}.gcl_0.edge_mlp.0.bias": b})
        for tail, ours in (("edge_mlp.2", "edge_l2"), ("node_mlp.0",
                                                       "node_l1"),
                           ("node_mlp.2", "node_l2"), ("att_mlp.0", "att")):
            sd[f"{p}.gcl_0.{tail}.weight"] = getattr(
                g, f"{ours}_kernel").detach().numpy().T
            sd[f"{p}.gcl_0.{tail}.bias"] = getattr(
                g, f"{ours}_bias").detach().numpy()
        for tname, ours in (("coord_mlp", "coord"),
                            ("cross_product_mlp", "cross")):
            w, b = joined(blk.gcl_equiv, ours)
            q = f"{p}.gcl_equiv.{tname}"
            sd.update({f"{q}.0.weight": w, f"{q}.0.bias": b,
                       f"{q}.2.weight": getattr(
                           blk.gcl_equiv, f"{ours}_l2_kernel").detach()
                       .numpy().T,
                       f"{q}.2.bias": getattr(
                           blk.gcl_equiv, f"{ours}_l2_bias").detach()
                       .numpy(),
                       f"{q}.4.weight": getattr(
                           blk.gcl_equiv, f"{ours}_out_kernel").detach()
                       .numpy().T})
    sd["dynamics.edge_embedding.weight"] = \
        dyn.edge_embedding.weight.detach().numpy()
    ours = flat(convert_state_dict(sd, cfg))
    ref = flat(jconvert(sd, jc))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    state = params_from_jax(convert_state_dict(sd, cfg))
    back = EGNNDynamics(cfg.egnn, NF, NF)
    back.load_state_dict(state, strict=True)
    for n, v in dyn.state_dict().items():
        np.testing.assert_allclose(back.state_dict()[n].numpy(), v.numpy(),
                                   rtol=0, atol=0, err_msg=n)


# ---------------------------------------------------------------------------
# pocket_conditioning_simple
# ---------------------------------------------------------------------------

T_SIMPLE, STEPS = 50, 10
SIMPLE_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def simple_setup():
    ds = JDataset("data/processed/virtual/val.npz")
    jlig, jpoc = jcollate([ds[i] for i in (3, 20)], drop_feature_cols=1)
    module = jdynamics.EGNNDynamics(jcfg.EGNNConfig(**EGNN), atom_nf=NF,
                                    residue_nf=NF)
    params = jax_params("plain")      # v3b's architecture, no variant
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    dyn.load_state_dict(params_from_jax(params))
    jd = jcfg.DiffusionConfig(timesteps=T_SIMPLE, loss_type="vlb")
    td = tcfg.DiffusionConfig(timesteps=T_SIMPLE, loss_type="vlb")
    jc = jcore.CondDiffusion(jS.make_schedule("polynomial_2", T_SIMPLE,
                                              5e-4), jd, NF, NF, simple=True)
    tc = tcore.CondDiffusion(tS.make_schedule("polynomial_2", T_SIMPLE,
                                              5e-4), td, NF, NF, simple=True)
    to_t = lambda nb: NodeBatch(*(torch.tensor(np.asarray(a))
                                  for a in nb))
    return dict(jlig=jlig, jpoc=jpoc, module=module, params=params,
                dyn=dyn.eval(), jc=jc, tc=tc, lig=to_t(jlig),
                poc=to_t(jpoc))


@pytest.mark.parametrize("training", [True, False])
def test_simple_loss_terms_equal_jax(training):
    s = simple_setup()
    key = jax.random.PRNGKey(11)
    jterms = jax.jit(lambda k, lig, poc: jlosses.conditional_loss_terms(
        k, s["jc"], lambda *a: s["module"].apply(s["params"], *a), lig, poc,
        training))(key, s["jlig"], s["jpoc"])
    k_t, k_noise, k_noise0 = jax.random.split(key, 3)
    t_int = jax.random.randint(k_t, (2,), 0 if training else 1,
                               T_SIMPLE + 1)
    shape = s["jlig"].xh.shape
    with torch.no_grad():
        tterms = tcore_terms(s, training, t_int, jax.random.normal(
            k_noise, shape), jax.random.normal(k_noise0, shape))
    assert sorted(tterms) == sorted(jterms)
    for k in jterms:
        np.testing.assert_allclose(
            np.asarray(tterms[k]), np.asarray(jterms[k]), rtol=SIMPLE_TOL,
            atol=SIMPLE_TOL, err_msg=k)
    # the full-dimensional likelihood: N * 3 degrees of freedom
    n = np.asarray(s["jlig"].mask).sum(1)
    np.testing.assert_allclose(np.asarray(tterms["delta_log_px"]),
                               -3.0 * n * np.log(1.0), atol=0)
    np.testing.assert_array_equal(
        s["tc"].subspace_dimensionality(torch.from_numpy(n)).numpy(), 3 * n)


def tcore_terms(s, training, t_int, noise, noise0):
    from diffndm_tpu_torch.train import losses as tlosses

    return tlosses.conditional_loss_terms(
        s["tc"], s["dyn"], s["lig"], s["poc"], training,
        torch.from_numpy(np.asarray(t_int).astype(np.float32)),
        torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(noise0)))


def test_simple_sampler_replay_equals_jax():
    s = simple_setup()
    sizes = np.array([7, 9])
    jsampler = JSampler(s["jc"], s["module"], s["params"],
                        jcfg.SampleConfig(), jparams["crossdock_full"])
    key = jax.random.PRNGKey(7)
    ref = jsampler.sample_given_pocket(key, s["jpoc"], sizes,
                                       timesteps=STEPS)
    nl = ref.ligand.x.shape[1]
    shape = (2, nl, 3 + NF)
    run_key, k_init = jax.random.split(key)
    steps = np.stack([np.array(jax.random.normal(jax.random.split(
        jax.random.fold_in(run_key, st), 4)[0], shape)) for st in
        range(STEPS)])
    noise = SamplerNoise(
        torch.from_numpy(np.array(jax.random.normal(k_init, shape))),
        torch.from_numpy(steps),
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(run_key, STEPS + 1), shape))))
    out = TSampler(s["tc"], s["dyn"], tcfg.SampleConfig()).sample_given_pocket(
        s["poc"], sizes, timesteps=STEPS, noise=noise)
    np.testing.assert_array_equal(out.ligand.mask.numpy(),
                                  np.asarray(ref.ligand.mask))
    for name, o, r in (("ligand x", out.ligand.x, ref.ligand.x),
                       ("pocket x", out.pocket.x, ref.pocket.x)):
        assert np.all(np.isfinite(o.numpy()))
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=SIMPLE_TOL, err_msg=name)
    m = np.asarray(ref.ligand.mask) > 0.5
    np.testing.assert_array_equal(out.ligand.h.numpy().argmax(-1)[m],
                                  np.asarray(ref.ligand.h).argmax(-1)[m])
    # the output is in the pocket's own frame: its centre of mass is kept
    pm = s["poc"].mask[..., None]
    com_in = (s["poc"].x * pm).sum(1) / pm.sum(1)
    com_out = (out.pocket.x * pm).sum(1) / pm.sum(1)
    np.testing.assert_allclose(com_out.numpy(), com_in.numpy(), atol=1e-4)
