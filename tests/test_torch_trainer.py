"""The port's Trainer against the JAX package's, step for step.

- Four micro-steps with ``accumulate_grad_batches=2``, the adaptive clip
  on and an EMA: the parameters, the EMA weights, the clip buffer, its
  count and the step equal the JAX ``Trainer``'s (one-device mesh) given
  the same batches and the draws JAX made, within rtol 1e-5.  The
  Lennard-Jones auxiliary term is off here: its r^-12 wall turns the
  fp32 rounding of one update into 1e-5-level changes of the next
  gradient at close contacts; ``test_torch_losses.py`` holds the term,
  its loss and its gradient, to JAX's on one step.
- ``torch.optim.AdamW(amsgrad=True)`` is not optax's amsgrad: it keeps the
  maximum of the uncorrected second moment.  The port's hand-written
  update equals optax's chain on the same gradients and torch's differs.
- A checkpoint written and read back restores params, EMA and step, and
  its params load through ``convert.params_from_jax``.
- ``BucketedLoader`` yields the JAX loader's batches, in its order, over
  three epochs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jparams  # noqa: E402
from diffndm_tpu.data import dataset as jdata  # noqa: E402
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.models.dynamics import init_dynamics  # noqa: E402
from diffndm_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffndm_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from diffndm_tpu_torch.data import dataset as tdata  # noqa: E402
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.trainer import (AmsgradState, Trainer,  # noqa: E402
                                             load_train_state)

T, NF = 50, 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
TRAIN = dict(lr=1e-3, accumulate_grad_batches=2, clip_grad=True,
             auxiliary_loss=False, ema_decay=0.9, batch_size=4)


def jax_flat(tree):
    return {"params/" + "/".join(str(k.key) for k in path[1:]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def to_torch(nb):
    return NodeBatch(*(torch.tensor(np.asarray(a)) for a in nb))


@pytest.fixture(scope="module")
def runs():
    """Four micro-steps on both sides from the same weights and batches."""
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    jd = jcfg.DiffusionConfig(timesteps=T)
    jc = jcore.CondDiffusion(jS.make_schedule("polynomial_2", T, 5e-4), jd,
                             NF, NF)
    tc = tcore.CondDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                             tcfg.DiffusionConfig(timesteps=T), NF, NF)
    module, params = init_dynamics(jcfg.EGNNConfig(**EGNN), NF, NF,
                                   jax.random.PRNGKey(5))
    jt = JTrainer(jc, module, params, jcfg.TrainConfig(**TRAIN), lj_rm=lj,
                  mesh=make_mesh(1, devices=jax.devices()[:1]))
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    dyn.load_state_dict(params_from_jax(params))
    tt = Trainer(tc, dyn, tcfg.TrainConfig(**TRAIN), lj_rm=lj)
    ds = jdata.ProcessedLigandPocketDataset(DATA)
    loader = jdata.BucketedLoader(ds, 4, drop_feature_cols=1)
    key = jax.random.PRNGKey(7)
    losses = []
    for i, (lig, poc) in zip(range(4), loader):
        key, k = jax.random.split(key)
        jloss, _ = jt.train_step(k, lig, poc)
        k_t, k_noise, _ = jax.random.split(k, 3)
        t_int = np.asarray(jax.random.randint(k_t, (4,), 0, T + 1))
        noise = np.asarray(jax.random.normal(k_noise, lig.xh.shape))
        tloss, _ = tt.train_step(to_torch(lig), to_torch(poc),
                                 torch.tensor(t_int, dtype=torch.float32),
                                 torch.tensor(noise))
        losses.append((tloss, jloss))
    return jt, tt, losses


def test_four_micro_steps_equal_jax(runs):
    jt, tt, losses = runs
    for tloss, jloss in losses:
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    st = jt.state
    assert tt.step == int(st.step) == 4
    assert tt.opt.count == 2 and tt.opt.mini_step == 0
    assert tt.gradnorm_count == int(st.gradnorm_count) == 5
    np.testing.assert_allclose(tt.gradnorm_buf.numpy(),
                               np.asarray(st.gradnorm_buf), rtol=1e-5)
    assert float(tt.gradnorm_buf[4]) == 3000.0      # not yet written
    for name, ours, ref in (("params", tt.params, st.params),
                            ("ema", tt.ema, st.ema_params)):
        mine = params_to_jax(dict(zip(tt.names, ours)))
        theirs = jax_flat(ref)
        assert sorted(mine) == sorted(theirs)
        for k, r in theirs.items():
            np.testing.assert_allclose(mine[k], r, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {k}")
    # the weights moved, and the EMA lags them
    first = params_from_jax(jax_flat(init_dynamics(
        jcfg.EGNNConfig(**EGNN), NF, NF, jax.random.PRNGKey(5))[1]))
    moved = [float((p - first[n]).abs().max()) for n, p in
             zip(tt.names, tt.params)]
    assert max(moved) > 1e-4


def amsgrad_sequence(n_params=2):
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5,)).astype(np.float32) for _ in range(n_params)]
    # a large gradient first, then small ones: the corrected second
    # moment's maximum stays at the first, the uncorrected one's does not
    grads = [[(g * s).astype(np.float32) for g in
              (rng.normal(size=(5,)) for _ in range(n_params))]
             for s in (10.0, 1.0, 1.0, 0.5)]
    return p0, grads


def test_hand_written_amsgrad_is_optax_and_torch_adamw_is_not():
    p0, grads = amsgrad_sequence()
    cfg = tcfg.TrainConfig(lr=1e-2, weight_decay=1e-12,
                           accumulate_grad_batches=1)
    tx = optax.chain(optax.scale_by_amsgrad(),
                     optax.add_decayed_weights(cfg.weight_decay),
                     optax.scale_by_learning_rate(cfg.lr))
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    ours = [torch.tensor(p) for p in p0]
    opt = AmsgradState(ours, cfg)
    theirs = [torch.tensor(p, requires_grad=True) for p in p0]
    adamw = torch.optim.AdamW(theirs, lr=cfg.lr, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=cfg.weight_decay,
                              amsgrad=True)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        assert opt.update(ours, [torch.tensor(x) for x in g])
        for t, x in zip(theirs, g):
            t.grad = torch.tensor(x)
        adamw.step()
    for o, r in zip(ours, params):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    diff = max(float(np.abs(t.detach().numpy() - np.asarray(r)).max())
               for t, r in zip(theirs, params))
    assert diff > 1e-4, diff


def test_accumulation_is_optax_multisteps():
    p0, grads = amsgrad_sequence(1)
    cfg = tcfg.TrainConfig(lr=1e-2, accumulate_grad_batches=2)
    tx = optax.MultiSteps(optax.chain(
        optax.scale_by_amsgrad(), optax.add_decayed_weights(1e-12),
        optax.scale_by_learning_rate(cfg.lr)), 2)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    ours = [torch.tensor(p) for p in p0]
    opt = AmsgradState(ours, cfg)
    for i, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        assert opt.update(ours, [torch.tensor(x) for x in g]) == (i % 2 == 1)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(params[0]),
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_round_trip(runs, tmp_path):
    _, tt, _ = runs
    path = str(tmp_path / "ckpt.npz")
    tt.save_checkpoint(path)
    params, ema, step = load_train_state(path)
    assert step == 4 and ema is not None
    fresh = Trainer(tt.core, EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF),
                    tt.cfg)
    fresh.load_checkpoint(path)
    assert fresh.step == 4
    for a, b in zip(fresh.params, tt.params):
        assert torch.equal(a, b)
    for a, b in zip(fresh.ema, tt.ema):
        assert torch.equal(a, b)
    model = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    model.load_state_dict(params_from_jax(params))
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(zip(tt.names, tt.params))[n])
    # a file without EMA weights restores the EMA from the params
    np.savez(tmp_path / "raw.npz", step=np.int32(2),
             **{f"params/{k}": v for k, v in params_to_jax(
                 dict(zip(tt.names, tt.params))).items()})
    fresh.load_checkpoint(str(tmp_path / "raw.npz"))
    assert fresh.step == 2
    for a, b in zip(fresh.ema, tt.params):
        assert torch.equal(a, b)


def test_bucketed_loader_yields_jax_batches_in_jax_order():
    jds = jdata.ProcessedLigandPocketDataset(DATA)
    tds = tdata.ProcessedLigandPocketDataset(DATA)
    jl = jdata.BucketedLoader(jds, 16, drop_feature_cols=1)
    tl = tdata.BucketedLoader(tds, 16, drop_feature_cols=1)
    assert len(jl) == len(tl)
    for _ in range(3):
        n = 0
        for (jlig, jpoc), (tlig, tpoc) in zip(jl, tl):
            for j, t in zip((*jlig, *jpoc), (*tlig, *tpoc)):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            n += 1
        assert n == len(jl)
    vj = jdata.BucketedLoader(jds, 16, shuffle=False, drop_feature_cols=1)
    vt = tdata.BucketedLoader(tds, 16, shuffle=False, drop_feature_cols=1)
    for (jlig, _), (tlig, _) in zip(vj, vt):
        np.testing.assert_array_equal(tlig.x.numpy(), np.asarray(jlig.x))
    np.testing.assert_allclose(tds.size_histogram(), jds.size_histogram())
