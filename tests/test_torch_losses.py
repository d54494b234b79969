"""The port's training loss against the JAX package's.

- ``conditional_loss_terms`` + ``assemble_loss`` equal JAX's term by
  term, given the timesteps and noise JAX drew from its key: the L2 loss
  in training (with the Lennard-Jones auxiliary term) and the VLB in
  eval, with and without ``virtual_node_idx``; rtol 1e-5 (fp32 through a
  small denoiser on both sides, sums in another order).
- The loss and its gradient with respect to every parameter of a small
  denoiser (2 layers, hidden 32) equal ``jax.value_and_grad`` of JAX's
  ``Trainer._loss_fn`` on the same weights: loss within rtol 1e-5, each
  gradient tensor within 1e-5 + 1e-4 of its largest entry (a weight's
  gradient sums over every edge of the batch).
- ``joint_loss_terms`` on the Lennard-Jones test's inputs, through a
  denoiser that predicts zero, equals JAX's term by term (the joint
  model's loss through a real denoiser: tests/test_torch_joint_loss.py).
"""

import dataclasses

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
from diffndm_tpu.models.dynamics import init_dynamics  # noqa: E402
from diffndm_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffndm_tpu.train import losses as jlosses  # noqa: E402
from diffndm_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train import losses as tlosses  # noqa: E402
from diffndm_tpu_torch.train.trainer import Trainer  # noqa: E402

T = 50
NF = 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
TRAIN = dict(auxiliary_loss=True, aux_max_weight=1e-3, aux_clamp_lj=3.0)


def jax_draws(key, ligand, training):
    """The draws JAX's conditional_loss_terms makes from ``key``."""
    k_t, k_noise, k_noise0 = jax.random.split(key, 3)
    b = ligand.x.shape[0]
    t_int = jax.random.randint(k_t, (b,), 0 if training else 1, T + 1)
    shape = ligand.xh.shape
    return (torch.from_numpy(np.asarray(t_int).astype(np.float32)),
            torch.from_numpy(np.asarray(jax.random.normal(k_noise, shape))),
            torch.from_numpy(np.asarray(jax.random.normal(k_noise0, shape))))


def joint_draw(key, b, nl, npk):
    """The raw draws of JAX's JointDiffusion.sample_joint_noise(key)."""
    kx, khl, khp = jax.random.split(key, 3)
    parts = [jax.random.normal(kx, (b, nl, 3)),
             jax.random.normal(khl, (b, nl, NF)),
             jax.random.normal(jax.random.fold_in(kx, 1), (b, npk, 3)),
             jax.random.normal(khp, (b, npk, NF))]
    return tuple(torch.from_numpy(np.array(jnp.concatenate(p, -1)))
                 for p in (parts[:2], parts[2:]))


def to_torch(nb):
    return NodeBatch(*(torch.from_numpy(np.asarray(a)) for a in nb))


@pytest.fixture(scope="module")
def setup():
    ds = JDataset(DATA)
    jlig, jpoc = jcollate([ds[i] for i in (3, 20, 40, 60)],
                          drop_feature_cols=1)
    egnn_j = jcfg.EGNNConfig(**EGNN)
    module, params = init_dynamics(egnn_j, NF, NF, jax.random.PRNGKey(3))
    egnn_t = tcfg.EGNNConfig(**EGNN)
    dyn = EGNNDynamics(egnn_t, NF, NF)
    dyn.load_state_dict(params_from_jax(params))
    return dict(jlig=jlig, jpoc=jpoc, module=module, params=params, dyn=dyn,
                lig=to_torch(jlig), poc=to_torch(jpoc))


def cores(loss_type, vidx):
    jd = jcfg.DiffusionConfig(timesteps=T, loss_type=loss_type,
                              virtual_node_idx=vidx)
    td = tcfg.DiffusionConfig(timesteps=T, loss_type=loss_type,
                              virtual_node_idx=vidx)
    return (jcore.CondDiffusion(jS.make_schedule("polynomial_2", T, 5e-4),
                                jd, NF, NF),
            tcore.CondDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                                td, NF, NF))


def close(name, out, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(out.detach() if isinstance(
        out, torch.Tensor) else out), np.asarray(ref), rtol=rtol, atol=atol,
        err_msg=name)


def test_lennard_jones_table_equals_jax():
    np.testing.assert_array_equal(
        dataset_params["crossdock_full"]["lennard_jones_rm"],
        jparams["crossdock_full"]["lennard_jones_rm"])


@pytest.mark.parametrize("loss_type,training", [("l2", True),
                                                ("vlb", False),
                                                ("vlb", True)])
@pytest.mark.parametrize("vidx", [None, 2])
def test_loss_terms_equal_jax(setup, loss_type, training, vidx):
    jc, tc = cores(loss_type, vidx)
    key = jax.random.PRNGKey(11)
    jeps = lambda z, p, t, lm, pm: setup["module"].apply(setup["params"], z,
                                                         p, t, lm, pm)
    teps = lambda z, p, t, lm, pm: setup["dyn"](z, p, t, lm, pm)
    jterms = jlosses.conditional_loss_terms(key, jc, jeps, setup["jlig"],
                                            setup["jpoc"], training)
    t_int, noise, noise0 = jax_draws(key, setup["jlig"], training)
    with torch.no_grad():
        tterms = tlosses.conditional_loss_terms(
            tc, teps, setup["lig"], setup["poc"], training, t_int, noise,
            noise0)
    assert sorted(tterms) == sorted(jterms)
    for k in jterms:
        close(k, tterms[k], jterms[k], atol=1e-5)
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    jnll, jinfo = jlosses.assemble_loss(
        jterms, jc, setup["jlig"], setup["jpoc"], jcfg.TrainConfig(**TRAIN),
        training, lj_rm=jnp.asarray(lj))
    tnll, tinfo = tlosses.assemble_loss(
        tterms, tc, setup["lig"], setup["poc"], tcfg.TrainConfig(**TRAIN),
        training, lj_rm=torch.from_numpy(lj))
    close("nll", tnll, jnll, atol=1e-4)
    assert sorted(tinfo) == sorted(jinfo)
    for k in jinfo:
        close(k, tinfo[k], jinfo[k], atol=1e-4)
    if loss_type == "l2" and training:
        assert "weighted_lj" in tinfo


def test_lj_potential_and_schedule_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 9, 3)).astype(np.float32)
    x[0, 1] = x[0, 0] + 1e-4        # a near-collision: the ratio cap
    h = rng.normal(size=(3, 9, NF)).astype(np.float32)
    mask = (rng.uniform(size=(3, 9)) > 0.2).astype(np.float32)
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    ref = jlosses.lj_potential(jnp.asarray(x), jnp.asarray(h),
                               jnp.asarray(mask), jnp.asarray(lj), 1.0, 3.0)
    out = tlosses.lj_potential(torch.from_numpy(x), torch.from_numpy(h),
                               torch.from_numpy(mask), torch.from_numpy(lj),
                               1.0, 3.0)
    close("lj", out, ref)
    for mode in ("linear", "constant"):
        close(mode, tlosses.aux_weight_schedule(T, 1e-3, mode),
              jlosses.aux_weight_schedule(T, 1e-3, mode), rtol=1e-6)
    # the joint model's terms on these inputs (ligand: x, h's argmax
    # types, mask; pocket: the same shifted), a denoiser that predicts
    # zero, JAX's draws: equal to JAX's
    from diffndm_tpu.diffusion import joint as jjoint
    from diffndm_tpu.structs import NodeBatch as JNodeBatch
    from diffndm_tpu_torch.diffusion import joint as tjoint

    onehot = np.eye(NF, dtype=np.float32)[h.argmax(-1)] * mask[..., None]
    parts = [(x * mask[..., None], onehot, mask),
             ((x + 2.0) * mask[..., None], onehot, mask)]
    jl, jp = (JNodeBatch(*(jnp.asarray(a) for a in p)) for p in parts)
    tl, tp = (NodeBatch(*(torch.from_numpy(a) for a in p)) for p in parts)
    zero_eps = (lambda zl, zp, t, lm, pm: (zl * 0, zp * 0))
    key = jax.random.PRNGKey(13)
    for training in (True, False):
        jterms = jlosses.joint_loss_terms(
            key, jjoint.JointDiffusion(jS.make_schedule("polynomial_2", T,
                                                        5e-4),
                                       jcfg.DiffusionConfig(timesteps=T),
                                       NF, NF),
            zero_eps, jl, jp, training)
        k_t, k_noise, k_noise0 = jax.random.split(key, 3)
        t_int = jax.random.randint(k_t, (3,), 0 if training else 1, T + 1)
        tterms = tlosses.joint_loss_terms(
            tjoint.JointDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                                  tcfg.DiffusionConfig(timesteps=T), NF, NF),
            zero_eps, tl, tp, training,
            torch.from_numpy(np.array(t_int, np.float32)),
            joint_draw(k_noise, 3, 9, 9), joint_draw(k_noise0, 3, 9, 9))
        assert sorted(tterms) == sorted(jterms)
        for k in jterms:
            close(f"joint {k}", tterms[k], jterms[k], atol=1e-5)


@pytest.mark.parametrize("vidx", [None, 2])
def test_loss_and_gradients_equal_jax_value_and_grad(setup, vidx):
    jc, tc = cores("l2", vidx)
    cfg = dict(TRAIN, accumulate_grad_batches=1)
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    jt = JTrainer(jc, setup["module"], setup["params"],
                  jcfg.TrainConfig(**cfg), lj_rm=lj,
                  mesh=make_mesh(1, devices=jax.devices()[:1]))
    key = jax.random.PRNGKey(21)
    (jloss, jinfo), jgrads = jax.value_and_grad(jt._loss_fn, has_aux=True)(
        setup["params"], key, setup["jlig"], setup["jpoc"], True)
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    dyn.load_state_dict(params_from_jax(setup["params"]))
    tt = Trainer(tc, dyn, tcfg.TrainConfig(**cfg), lj_rm=lj)
    t_int, noise, _ = jax_draws(key, setup["jlig"], True)
    with torch.enable_grad():
        loss, info = tt._loss(setup["lig"], setup["poc"], True, t_int, noise)
        grads = torch.autograd.grad(loss, tt.params, allow_unused=True)
    close("loss", loss, jloss)
    state = {n: (torch.zeros_like(p) if g is None else g)
             for n, p, g in zip(tt.names, tt.params, grads)}
    ours = params_to_jax(state)
    ref = {"params/" + "/".join(str(k.key) for k in path[1:]): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        err = float(np.abs(ours[k] - r).max())
        assert err <= 1e-5 + 1e-4 * float(np.abs(r).max()), (k, err)
    # the pocket's decoder gets no gradient in the conditional model
    assert any(float(np.abs(v).max()) == 0.0 for k, v in ref.items()
               if "residue_decoder" in k)


def test_train_config_from_yaml_equals_jax_cli_reading():
    """The fields the JAX CLI reads, from v3b's hparams."""
    import yaml

    with open("examples/checkpoints/virtual_cond_v3b/hparams.yaml") as f:
        raw = yaml.safe_load(f)
    ours = tcfg.train_config_from_yaml(raw)
    lp = raw["loss_params"]
    ref = jcfg.TrainConfig(
        lr=float(raw["lr"]), batch_size=int(raw["batch_size"]),
        n_epochs=int(raw["n_epochs"]), clip_grad=bool(raw["clip_grad"]),
        accumulate_grad_batches=int(raw["accumulate_grad_batches"]),
        auxiliary_loss=bool(raw["auxiliary_loss"]),
        aux_max_weight=float(lp["max_weight"]),
        aux_schedule=lp["schedule"], aux_clamp_lj=float(lp["clamp_lj"]),
        eval_epochs=int(raw["eval_epochs"]),
        ema_decay=float(raw["ema_decay"]))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    ours_f = dataclasses.fields(tcfg.TrainConfig)
    ref_f = dataclasses.fields(jcfg.TrainConfig)
    assert [(f.name, f.default) for f in ours_f] == [
        (f.name, f.default) for f in ref_f]
    egnn = tcfg.model_config_from_yaml(raw).egnn
    assert egnn.remat is True


def test_virtual_nodes_equal_jax():
    """AppendVirtualNodes pads a ligand exactly as JAX's (the same numpy
    draws from the same seed), and strip_virtual_nodes drops the same
    atoms."""
    from diffndm_tpu.data import virtual as jvirtual
    from diffndm_tpu.structs import NodeBatch as JNodeBatch
    from diffndm_tpu_torch.data import virtual as tvirtual
    from diffndm_tpu_torch.data.dataset import LigandPocketPair

    ds = JDataset(DATA)
    enc = jparams["crossdock_full"]["atom_encoder"]
    jt = jvirtual.AppendVirtualNodes(30, enc, seed=4)
    tt = tvirtual.AppendVirtualNodes(30, enc, seed=4)
    for i in (0, 5, 9):
        p = ds[i]
        dropped = LigandPocketPair(p.lig_coords, p.lig_one_hot[:, :NF],
                                   p.pocket_coords, p.pocket_one_hot, p.name)
        ref, out = jt(dropped), tt(dropped)
        for a, b in zip((out.lig_coords, out.lig_one_hot),
                        (ref.lig_coords, ref.lig_one_hot)):
            np.testing.assert_array_equal(a, b)
        assert out.lig_one_hot.shape == (30, len(enc))
    rng = np.random.default_rng(8)
    h = np.eye(len(enc), dtype=np.float32)[rng.integers(0, len(enc),
                                                        (2, 12))]
    x = rng.normal(size=(2, 12, 3)).astype(np.float32)
    mask = np.ones((2, 12), np.float32)
    vidx = enc["others"]
    ref = jvirtual.strip_virtual_nodes(
        JNodeBatch(jnp.asarray(x), jnp.asarray(h), jnp.asarray(mask)), vidx)
    out = tvirtual.strip_virtual_nodes(
        NodeBatch(torch.from_numpy(x), torch.from_numpy(h),
                  torch.from_numpy(mask)), vidx)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
