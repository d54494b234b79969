"""The learned noise schedule against the JAX package's.

- ``GammaNetwork``: its values at random times, the gradient of a
  weighted sum of them with respect to every parameter,
  ``LearnedGamma.table`` and ``at_step``: on a flax init in float64
  within rtol 1e-10 of JAX's, and in float32 within rtol 1e-5 on weights
  of a trained network's shape (``conditioned``: on a fresh init the
  normalisation cancels, and JAX's own float32 values sit 1.5e-4 from
  float64).  The VLB and trainer tests below use such weights too.
- The VLB training loss and the gradients of both trees (the dynamics and
  the gamma network) against JAX's (``jax.value_and_grad`` of the JAX
  ``Trainer._loss_fn``, as its first train step takes them) under the
  timesteps and noise JAX drew: the loss within rtol 1e-5, each gradient
  tensor within 1e-5 + 1e-4 of its largest entry (a weight's gradient
  sums over every edge of the batch).
- T = 10 here: the VLB weight 1 - exp(gamma_s - gamma_t) takes the
  difference of the gammas one step apart, and the two implementations'
  float32 rounding of gamma (a 1024-term sum, ~2e-6) is 1e-5 of that
  difference at T = 50 (4e-6 at T = 10).
- Four micro-steps of the port's Trainer with the gamma network against
  the JAX ``Trainer`` with ``{"dynamics", "gamma"}`` (accumulation 2, the
  adaptive clip over both trees, an EMA of both): the losses and the clip
  buffer within rtol 1e-5, as tests/test_torch_trainer.py holds them
  without a gamma tree; parameters and EMA within rtol 1e-5 (atol 1e-7)
  but for at most 0.1 % of the elements, and those within 1 % of the two
  updates' lr (``ADAM_SHARE``: the VLB gradients agree to 1e-5 of each
  tensor's largest entry, which Adam's division can enlarge for an
  element whose two gradients nearly cancel).
- The train CLI with ``diffusion_noise_schedule: learned``: both trees in
  its checkpoints, a resume that restores them, and the weights loading
  into a ``DiffNDM`` through ``save_params_npz`` / ``load_params_npz``.
- The converter carries the gamma tree both ways.
"""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.data import dataset as jdata  # noqa: E402
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion.learned_gamma import \
    make_learned_gamma  # noqa: E402
from diffndm_tpu.models.dynamics import init_dynamics  # noqa: E402
from diffndm_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffndm_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.cli import train as train_cli  # noqa: E402
from diffndm_tpu_torch.convert import (gamma_params_from_jax,  # noqa: E402
                                       params_from_jax, params_to_jax)
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.diffusion.learned_gamma import (  # noqa: E402
    GammaNetwork, LearnedGamma)
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.trainer import (Trainer,  # noqa: E402
                                             load_train_state)

torch.set_num_threads(1)

T, NF = 10, 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
TRAIN = dict(lr=1e-3, accumulate_grad_batches=2, clip_grad=True,
             auxiliary_loss=False, ema_decay=0.9, batch_size=4)
# l3's bias cancels in the normalisation g(t) - g(0): its exact gradient
# is 0, and what float32 leaves of it is noise
BIAS_L3 = "gamma/params/l3/bias"
# Adam divides each element's first moment by its second: where an
# element's gradients of the two updates nearly cancel, the VLB gradients'
# 1e-5 agreement (test_vlb_loss_and_both_trees_gradients_equal_jax) turns
# into up to this share of the step (lr) for that element
ADAM_SHARE = 1e-2


def flat(tree, prefix=""):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def to_torch(nb):
    return NodeBatch(*(torch.tensor(np.asarray(a)) for a in nb))


def conditioned(learned, seed=5, hidden=1024):
    """The schedule with weights of the shape a trained one has: l1 and l2
    raised so that sigmoid(l2(l1(t))) moves across [0, 1], and g(t) - g(0)
    is of the order of g.  A fresh init's sigmoids sit near 0.5, its
    g(t) - g(0) is about 1 % of g, and the normalisation's difference of
    two 1024-term sums leaves float32 1e-5 of the normalised value (1.5e-4
    of gamma): JAX's own float32 values are that far from float64."""
    rng = np.random.default_rng(seed)
    p = dict(jax.tree_util.tree_map(np.asarray, learned.params)["params"])
    p["l1"] = dict(kernel=np.ones((1, 1), np.float32),
                   bias=np.zeros(1, np.float32))
    p["l2"] = dict(
        kernel=rng.normal(1.5, 0.5, (1, hidden)).astype(np.float32),
        bias=rng.normal(-2.0, 1.0, (hidden,)).astype(np.float32))
    return learned._replace(params={"params": jax.tree_util.tree_map(
        jnp.asarray, p)})


@pytest.fixture(scope="module")
def gamma():
    """The JAX schedule (a flax init, and the same with conditioned
    weights) and the port's networks on their weights."""
    init = make_learned_gamma(T, jax.random.PRNGKey(2))
    learned = conditioned(init)
    net = GammaNetwork()
    net.load_state_dict(gamma_params_from_jax(learned.params), strict=True)
    return init, learned, net


def in_float64(learned):
    """JAX's parameters and the port's network on them, in float64."""
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v, np.float64)), learned.params)
    net = GammaNetwork().double()
    net.load_state_dict({k: v.double() for k, v in
                         gamma_params_from_jax(learned.params).items()})
    return params, net


def weighted_grads(net, t, w):
    """The network's values at t and the gradients of their sum weighted
    by w, under JAX's flat names, in the network's precision."""
    out = net(torch.from_numpy(t).to(net.gamma_0.dtype))
    (out * torch.from_numpy(w).to(out.dtype)).sum().backward()
    return out.detach().numpy(), {
        "params/" + n.replace(".", "/"):
        (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        for n, p in net.named_parameters()}


def test_gamma_network_values_and_gradients_equal_jax(gamma):
    """Values at random times and the gradient of their weighted sum with
    respect to every parameter: on the flax init in float64 within rtol
    1e-10 (the same function); on the conditioned weights in float32
    within rtol 1e-5 (atol 1e-6 of the largest entry).  l3's bias cancels
    in g(t) - g(0): the port's gradient of it is 0, JAX's rounding
    residue of it within the atol."""
    init, learned, net = gamma
    rng = np.random.default_rng(0)
    t = rng.uniform(size=(7,)).astype(np.float32)
    t[:2] = (0.0, 1.0)
    w = rng.normal(size=(7,)).astype(np.float32)
    for lg, tol, dtype in ((init, 1e-10, np.float64),
                           (learned, 1e-5, np.float32)):
        with jax.enable_x64(dtype == np.float64):
            params, net64 = in_float64(lg)
            if dtype == np.float32:
                params, mine = lg.params, net
            else:
                mine = net64
            tj = jnp.asarray(t, dtype)
            ref = np.asarray(lg.module.apply(params, tj))
            theirs = flat(jax.grad(lambda p: jnp.sum(
                lg.module.apply(p, tj) * w.astype(dtype)))(params))
        mine.zero_grad()
        out, ours = weighted_grads(mine, t, w)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * scale)
        np.testing.assert_allclose(out[:2], [-5.0, 10.0], rtol=tol)
        assert sorted(ours) == sorted(theirs)
        top = max(float(np.abs(r).max()) for r in theirs.values())
        for k, r in theirs.items():
            np.testing.assert_allclose(ours[k], r, rtol=tol,
                                       atol=0.1 * tol * top, err_msg=k)
        assert float(np.abs(theirs["params/l2/kernel"]).max()) > 0


def test_learned_table_and_steps_equal_jax(gamma):
    """The table and at_step on the conditioned weights within rtol 1e-5
    of JAX's (and on the flax init in float64 within 1e-10); the network
    at t, not at a table index; the table differentiable; on the flax
    init in float32 the port within 5e-6 of float64 (GammaNetwork takes
    g(t) - g(0) before rounding a sum; JAX's float32 table is further
    off)."""
    init, learned, net = gamma
    steps = np.array([0, 3, 17, 50])
    with jax.enable_x64(True):
        params64, net64 = in_float64(init)
        lg64 = init._replace(params=params64)
        table64 = np.asarray(lg64(jnp.arange(T + 1, dtype=jnp.float64)
                                  / T))
    sched, sched64 = LearnedGamma(net, T), LearnedGamma(net64, T)
    with torch.no_grad():
        np.testing.assert_allclose(sched64.table.numpy(), table64,
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(sched.table.numpy(),
                                   np.asarray(learned.table), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            sched.at_step(torch.from_numpy(steps)).numpy(),
            np.asarray(learned.at_step(jnp.asarray(steps))), rtol=1e-5,
            atol=1e-5)
        t = torch.tensor([0.013])
        assert float(sched(t)) != float(sched.table[1])
        # on the fresh init the port's float32 table stays within 5e-6 of
        # float64, where JAX's difference of two rounded sums does not
        fresh = GammaNetwork()
        fresh.load_state_dict(gamma_params_from_jax(init.params))
        ours32 = LearnedGamma(fresh, T).table.numpy()
        assert np.abs(ours32 - table64).max() <= 5e-6
        assert np.abs(np.asarray(init.table) - table64).max() > 1e-5
    assert sched.table.requires_grad


def test_converter_round_trips_gamma_tree(gamma):
    _, learned, net = gamma
    ours = params_to_jax(net.state_dict())
    ref = flat(learned.params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert ours["params/l2/kernel"].shape == (1, 1024)
    with pytest.raises(ValueError, match="not a GammaNetwork tree"):
        gamma_params_from_jax({"params": {"l1": {"kernel": np.ones((1, 1))}}})


# ---------------------------------------------------------------------------
# VLB training with the gamma tree
# ---------------------------------------------------------------------------

def jax_draws(key, ligand):
    """The draws of JAX's conditional_loss_terms (training) from key."""
    k_t, k_noise, _ = jax.random.split(key, 3)
    b = ligand.x.shape[0]
    t_int = jax.random.randint(k_t, (b,), 0, T + 1)
    return (torch.from_numpy(np.asarray(t_int).astype(np.float32)),
            torch.tensor(np.asarray(jax.random.normal(k_noise,
                                                      ligand.xh.shape))))


def batches():
    """Four batches of four complexes of the same padded shape ([4, 24]
    ligand and [4, 64] pocket rows: one JAX compile)."""
    ds = jdata.ProcessedLigandPocketDataset(DATA)
    return [jdata.collate_padded([ds[i] for i in idx], drop_feature_cols=1)
            for idx in ((3, 20, 40, 60), (19, 11, 5, 17), (8, 37, 52, 28),
                        (14, 27, 36, 64))]


def build(seed_dyn=5, seed_gamma=6):
    """The JAX and the port's cores, modules and trainers' arguments on
    the same weights, VLB with a learned schedule."""
    jd = jcfg.DiffusionConfig(timesteps=T, loss_type="vlb",
                              noise_schedule="learned")
    learned = conditioned(make_learned_gamma(T, jax.random.PRNGKey(
        seed_gamma)), seed_gamma)
    jc = jcore.CondDiffusion(learned, jd, NF, NF)
    module, params = init_dynamics(jcfg.EGNNConfig(**EGNN), NF, NF,
                                   jax.random.PRNGKey(seed_dyn))
    td = tcfg.DiffusionConfig(timesteps=T, loss_type="vlb",
                              noise_schedule="learned")
    sched = tS.make_schedule("learned", T)
    sched.network.load_state_dict(gamma_params_from_jax(learned.params))
    tc = tcore.CondDiffusion(sched, td, NF, NF)
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    dyn.load_state_dict(params_from_jax(params))
    return (jc, module, {"dynamics": params, "gamma": learned.params},
            tc, dyn, sched.network)


def ours_flat(names, tensors, sub):
    return {f"{sub}/{k}": v for k, v in params_to_jax(dict(
        zip(names, tensors))).items()}


def test_vlb_loss_and_both_trees_gradients_equal_jax(runs):
    """The first micro-step: JAX's train step takes value_and_grad of
    ``Trainer._loss_fn`` over both trees and clips it; its MultiSteps
    accumulator then holds exactly those gradients, as the port's holds
    its own."""
    _, tt, losses, _, (theirs, mine) = runs
    np.testing.assert_allclose(*losses[0], rtol=1e-5)
    n = len(tt.params)
    ours = ours_flat(tt.names, mine[:n], "dynamics")
    ours.update(ours_flat(tt.gamma_names, mine[n:], "gamma"))
    ref = flat(theirs)
    assert sorted(ours) == sorted(ref)
    top = max(float(np.abs(r).max()) for k, r in ref.items()
              if k.startswith("gamma/"))
    for k, r in ref.items():
        err = float(np.abs(ours[k] - r).max())
        if k == BIAS_L3:
            # exactly 0: float32 noise on both sides
            assert max(float(np.abs(ours[k]).max()),
                       float(np.abs(r).max())) <= 1e-6 * top, k
            continue
        assert err <= 1e-5 + 1e-4 * float(np.abs(r).max()), (k, err)
    # VLB reaches the schedule: its ends and its network
    for k in ("gamma/params/gamma_0", "gamma/params/gamma_1",
              "gamma/params/l2/kernel"):
        assert float(np.abs(ref[k]).max()) > 0, k


@pytest.fixture(scope="module")
def runs():
    """Four micro-steps on both sides from the same weights and batches."""
    jc, module, jparams_, tc, dyn, net = build()
    # a copy: the JAX step donates its state's buffers
    first = jax.tree_util.tree_map(np.array, jparams_)
    jt = JTrainer(jc, module, jparams_, jcfg.TrainConfig(**TRAIN),
                  mesh=make_mesh(1, devices=jax.devices()[:1]),
                  gamma_module=jc.schedule.module)
    tt = Trainer(tc, dyn, tcfg.TrainConfig(**TRAIN), gamma=net)
    key = jax.random.PRNGKey(7)
    losses = []
    grads = None
    for lig, poc in batches():
        key, k = jax.random.split(key)
        jloss, _ = jt.train_step(k, lig, poc)
        tloss, _ = tt.train_step(to_torch(lig), to_torch(poc),
                                 *jax_draws(k, lig))
        losses.append((tloss, jloss))
        if grads is None:
            # the first micro-step's clipped gradients, in the optimizers'
            # accumulators (copied: the next JAX step donates them)
            grads = (jax.tree_util.tree_map(
                np.array, jt.state.opt_state.acc_grads),
                [a.clone() for a in tt.opt.acc])
    return jt, tt, losses, first, grads


def test_four_micro_steps_with_gamma_equal_jax(runs):
    jt, tt, losses, first, _ = runs
    for tloss, jloss in losses:
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    st = jt.state
    assert tt.step == int(st.step) == 4
    assert tt.gradnorm_count == int(st.gradnorm_count) == 5
    np.testing.assert_allclose(tt.gradnorm_buf.numpy(),
                               np.asarray(st.gradnorm_buf), rtol=1e-5)
    n = len(tt.params)
    lr, updates = TRAIN["lr"], 2
    for name, ours, ref in (("params", tt.trained, st.params),
                            ("ema", tt.ema, st.ema_params)):
        mine = ours_flat(tt.names, ours[:n], "dynamics")
        mine.update(ours_flat(tt.gamma_names, ours[n:], "gamma"))
        theirs = flat(ref)
        assert sorted(mine) == sorted(theirs)
        beyond, total = 0, 0
        for k, r in theirs.items():
            err = np.abs(mine[k] - r)
            if k == BIAS_L3:
                # trained on float32 noise of either sign (at most lr per
                # update); no effect on gamma
                assert float(err.max()) <= 2 * lr * updates
                continue
            beyond += int((err > 1e-7 + 1e-5 * np.abs(r)).sum())
            total += r.size
            assert float(err.max()) <= \
                1e-5 * float(np.abs(r).max()) + ADAM_SHARE * lr * updates, \
                f"{name} {k}"
        assert beyond <= 1e-3 * total, (name, beyond, total)
    # the gamma tree moved
    g0 = gamma_params_from_jax(first["gamma"])
    moved = max(float((p - g0[n]).abs().max())
                for n, p in zip(tt.gamma_names, tt.gamma_params))
    assert moved > 1e-5


def test_trainer_checkpoint_holds_both_trees(runs, tmp_path):
    _, tt, _, _, _ = runs
    path = str(tmp_path / "ckpt.npz")
    tt.save_checkpoint(path)
    with np.load(path) as f:
        keys = set(f.files)
    assert "params/gamma/params/l2/kernel" in keys
    assert "ema_params/gamma/params/gamma_0" in keys
    assert any(k.startswith("params/dynamics/params/egnn/") for k in keys)
    _, _, _, tc, dyn, net = build(seed_dyn=9, seed_gamma=10)
    fresh = Trainer(tc, dyn, tt.cfg, gamma=net)
    fresh.load_checkpoint(path)
    assert fresh.step == tt.step
    for a, b in zip(fresh.trained + fresh.ema, tt.trained + tt.ema):
        assert torch.equal(a, b)
    # a checkpoint without the gamma tree does not load into it
    plain = Trainer(tc, EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF),
                    tt.cfg)
    with pytest.raises(ValueError, match="gamma"):
        plain.load_checkpoint(path)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

CLI_CFG = {
    "run_name": "learned", "dataset": "crossdock",
    "datadir": "data/processed/virtual", "mode": "pocket_conditioning",
    "pocket_representation": "full-atom", "batch_size": 4, "lr": 1.0e-3,
    "n_epochs": 1, "clip_grad": True, "accumulate_grad_batches": 1,
    "auxiliary_loss": False, "ema_decay": 0.9, "eval_epochs": 1,
    "egnn_params": {
        "joint_nf": 8, "hidden_nf": 16, "n_layers": 2, "inv_sublayers": 1,
        "attention": True, "tanh": True, "norm_constant": 1,
        "reflection_equivariant": False, "edge_cutoff_ligand": None,
        "edge_cutoff_pocket": 5.0, "edge_cutoff_interaction": 5.0},
    "diffusion_params": {
        "diffusion_steps": 10, "diffusion_noise_schedule": "learned",
        "diffusion_noise_precision": 5.0e-4, "diffusion_loss_type": "vlb",
        "normalize_factors": [1, 4]},
}


def test_train_cli_learned_schedule_checkpoints_and_resumes(tmp_path):
    cfg_path = tmp_path / "learned.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(CLI_CFG, logdir=str(tmp_path / "runs")), f)
    summary = train_cli.main(["--config", str(cfg_path), "--max_steps", "3",
                              "--device", "cpu"])
    assert summary["steps"] == 3 and all(np.isfinite(summary["train_losses"]))
    assert np.isfinite(summary["best_val"])
    outdir = summary["outdir"]
    params, ema, step = load_train_state(os.path.join(outdir, "last.npz"))
    assert step == 3 and ema is not None
    assert "gamma/params/l2/kernel" in params and \
        "gamma/params/gamma_1" in ema
    # the gamma network trained: its ends moved off -5 and 10
    assert float(params["gamma/params/gamma_0"][0]) != -5.0
    # a resume restores both trees, then trains on
    again = train_cli.main(["--config", str(cfg_path), "--max_steps", "1",
                            "--resume", os.path.join(outdir, "last.npz"),
                            "--device", "cpu", "--set", "eval_epochs=5"])
    p2, _, step2 = load_train_state(os.path.join(again["outdir"],
                                                 "last.npz"))
    assert step2 == 4
    assert float(p2["gamma/params/gamma_0"][0]) != float(
        params["gamma/params/gamma_0"][0])
    # the EMA weights, both trees, load into a model and back
    model = DiffNDM.from_yaml(str(cfg_path), device="cpu")
    model.set_params(params_from_jax(
        {k[len("dynamics/"):]: v for k, v in ema.items()
         if k.startswith("dynamics/")}),
        gamma_params_from_jax({k[len("gamma/"):]: v for k, v in ema.items()
                               if k.startswith("gamma/")}))
    npz = str(tmp_path / "weights.npz")
    model.save_params_npz(npz)
    other = DiffNDM.from_yaml(str(cfg_path), device="cpu")
    other.load_params_npz(npz)
    for a, b in zip(list(model.dynamics.parameters())
                    + list(model.gamma.parameters()),
                    list(other.dynamics.parameters())
                    + list(other.gamma.parameters())):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        other.gamma.gamma_1.detach().numpy(), ema["gamma/params/gamma_1"])
    with pytest.raises(ValueError, match="gamma tree"):
        DiffNDM.from_yaml("configs/virtual_cond_v3b.yml",
                          device="cpu").load_params_npz(npz)


def test_sampling_looks_the_learned_schedule_up_on_the_run_grid(
        monkeypatch, gamma):
    """``run_schedule``: a sampling run evaluates the gamma network once on
    its grid k / timesteps, the same values as the per-step calls the JAX
    sampler makes (within 1e-6), and restores the schedule after.  A
    fixed-noise run with the grid and one calling the network at every
    step (the JAX sampler's way) end within 1e-5 of each other, of the
    coordinates' largest magnitude (a random tiny denoiser's trajectory
    leaves them at hundreds of A)."""
    import contextlib

    _, learned, net = gamma
    core = tcore.CondDiffusion(LearnedGamma(net, T), tcfg.DiffusionConfig(
        timesteps=T, loss_type="vlb", noise_schedule="learned"), NF, NF)
    steps = 7
    t = torch.arange(steps + 1) / steps
    with torch.no_grad():
        per_call = torch.stack([core.schedule(v) for v in t])
        with core.run_schedule(steps):
            assert not isinstance(core.schedule, LearnedGamma)
            looked_up = core.schedule(t)
            s_norm = torch.full((3,), 4.0) / steps
            np.testing.assert_allclose(core.schedule(s_norm).numpy(),
                                       per_call[4].numpy().repeat(3),
                                       rtol=1e-6, atol=1e-6)
    assert core.schedule.network is net
    np.testing.assert_allclose(looked_up.numpy(), per_call.numpy(),
                               rtol=1e-6, atol=1e-6)

    cfg = tcfg.model_config_from_yaml(dict(CLI_CFG))
    model = DiffNDM(cfg, device="cpu")
    model.gamma.load_state_dict(net.state_dict())
    ds = jdata.ProcessedLigandPocketDataset(DATA)
    pocket = model.pocket_from_dataset(ds[3], 2)
    sizes = np.array([6, 8])
    nl = 8
    g = torch.Generator().manual_seed(0)
    shape = (2, nl, 3 + cfg.atom_nf)
    from diffndm_tpu_torch.diffusion.sampler import SamplerNoise
    noise = SamplerNoise(torch.randn(shape, generator=g),
                         torch.randn((steps,) + shape, generator=g),
                         torch.randn(shape, generator=g))
    grid = model.sample_given_pocket(pocket, sizes, timesteps=steps,
                                     noise=noise)
    monkeypatch.setattr(tcore.CondDiffusion, "run_schedule",
                        lambda self, timesteps: contextlib.nullcontext())
    each = model.sample_given_pocket(pocket, sizes, timesteps=steps,
                                     noise=noise)
    scale = float(np.abs(each.ligand.x.numpy()).max())
    np.testing.assert_allclose(grid.ligand.x.numpy(), each.ligand.x.numpy(),
                               rtol=0, atol=1e-5 * scale)
    assert np.all(np.isfinite(grid.ligand.x.numpy()))
