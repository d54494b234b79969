"""The port's data parallelism (``diffndm_tpu_torch.parallel``) against the
JAX package's device mesh, on the CPU over gloo.

- ``pad_rows`` pads as the JAX trainer's ``_pad_to_mesh`` does, row for
  row, for every batch size 1..9 over 1..4 ranks.
- The data-parallel ``Trainer`` at 2 ranks (B = 4) and at 3 ranks (B = 5,
  padded to 6) against the JAX ``Trainer`` over ``make_mesh(n)`` of the
  virtual CPU devices: the same converted weights, batches and the draws
  JAX made for the padded batch; the loss, every ``info`` entry, the
  parameters and the EMA after 1 and 3 micro-steps within rtol 1e-5 (as
  ``test_torch_trainer.py``), and every rank's state equal to rank 0's
  bit for bit.
- The data-parallel ``ConditionalSampler`` at 2 ranks on
  ``test_multi_pocket.py``'s sharded setup (T = 6, SPSA + ATP with 3
  groups; B = 8) under the noise JAX's key schedule draws, against the
  port's single-process sampler and JAX's mesh sampler: coordinates within
  2e-4, atom types and masks equal, the forwards of every rank as
  ``count_forwards`` counts.  Three selection scopes: the global top-B,
  ``group_size`` (B = 12 in groups of 4, so that the middle group
  straddles the two ranks) and ``per_sample``.  Without fixed noise the
  ranks draw from generators seeded alike and give one process's
  ligands.
- The train CLI's per-rank run (``cli.train.run``) at 2 ranks equals the
  one-process run on the same config (losses within rtol 1e-5), and only
  rank 0 writes the run's files.

The ranks are processes started by ``parallel.mesh.spawn`` (gloo, one
thread each); their code is in ``torch_dp_ranks.py``, which imports no
JAX (checked).  Every spawn joins within a timeout, so a hung rank fails
its test; a rank that raises or hangs fails ``spawn`` itself (checked).
"""

import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jparams  # noqa: E402
from diffndm_tpu.data import dataset as jdata  # noqa: E402
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.sampler import \
    ConditionalSampler as JSampler  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JDynamics  # noqa: E402
from diffndm_tpu.models.dynamics import init_dynamics  # noqa: E402
from diffndm_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JBatch  # noqa: E402
from diffndm_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from diffndm_tpu_torch.cli import train as train_cli  # noqa: E402
from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,  # noqa: E402
                                      SPSAConfig, model_config_from_yaml,
                                      train_config_from_yaml)
from diffndm_tpu_torch.convert import params_from_jax  # noqa: E402
from diffndm_tpu_torch.diffusion.sampler import count_forwards  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.parallel import mesh  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_sampler import jax_guided_noise  # noqa: E402
from test_torch_train_cli import CFG as CLI_CFG  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402

JOIN_TIMEOUT = 120.0     # seconds a spawn may take before it fails
RTOL, ATOL = 1e-5, 1e-7
# the KL prior's info entry against JAX's: a difference of fp32 terms of
# order 3 * atoms (~10^2) per row, so its rounding is ~10^2 * 6e-8
KL_ATOL = 1e-5
COORD_ATOL = 2e-4


def spawn(fn, world, spec):
    return mesh.spawn(fn, world, "gloo", args=(spec,), timeout=JOIN_TIMEOUT,
                      collective_timeout=JOIN_TIMEOUT)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("b", range(1, 10))
def test_pad_rows_is_jax_pad_to_mesh(b, n):
    rows = np.arange(b, dtype=np.float32)
    jb = JBatch(x=jnp.asarray(np.broadcast_to(rows[:, None, None], (b, 2, 3))),
                h=jnp.asarray(np.broadcast_to(rows[:, None, None], (b, 2, 4))),
                mask=jnp.ones((b, 2)))
    fake = types.SimpleNamespace(mesh=types.SimpleNamespace(
        shape={"data": n, "model": 1}))
    jlig, _ = JTrainer._pad_to_mesh(fake, jb, jb)
    tb = NodeBatch(*(torch.from_numpy(np.array(a)) for a in jb))
    tlig, tpoc = mesh.pad_rows(tb, tb, n)
    assert tlig.x.shape[0] % n == 0
    for ours, theirs in zip((*tlig, *tpoc), (*jlig, *jlig)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(tlig.x[:, 0, 0].numpy(),
                                  mesh.pad_index(b, n))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

T, NF, STEPS = 50, 10, 3
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
TRAIN = dict(lr=1e-3, accumulate_grad_batches=2, clip_grad=True,
             auxiliary_loss=False, ema_decay=0.9)
RECORD = (1, 3)


def jax_flat(tree):
    return {"/".join(str(k.key) for k in path): np.array(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=[(2, 4), (3, 5)],
                ids=["2ranks-B4", "3ranks-B5"])
def train_runs(request):
    """STEPS micro-steps of JAX's mesh trainer and of the port's trainer
    on ``world`` ranks, from the same weights, batches and draws."""
    world, b = request.param
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    jc = jcore.CondDiffusion(jS.make_schedule("polynomial_2", T, 5e-4),
                             jcfg.DiffusionConfig(timesteps=T), NF, NF)
    module, params = init_dynamics(jcfg.EGNNConfig(**EGNN), NF, NF,
                                   jax.random.PRNGKey(5))
    # before the JAX trainer takes (and donates) the weights
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    jt = JTrainer(jc, module, params,
                  jcfg.TrainConfig(batch_size=b, **TRAIN), lj_rm=lj,
                  mesh=make_mesh(n_data=world, devices=jax.devices()[:world]))
    loader = jdata.BucketedLoader(jdata.ProcessedLigandPocketDataset(DATA), b,
                                  drop_feature_cols=1)
    key = jax.random.PRNGKey(7)
    bp = b + (-b) % world
    steps, jax_steps = [], []
    for i, (lig, poc) in zip(range(STEPS), loader):
        key, k = jax.random.split(key)
        loss, info = jt.train_step(k, lig, poc)
        rec = dict(loss=loss, info=info)
        if i + 1 in RECORD:
            rec.update(params=jax_flat(jt.state.params),
                       ema=jax_flat(jt.state.ema_params),
                       buf=np.array(jt.state.gradnorm_buf))
        jax_steps.append(rec)
        k_t, k_noise, _ = jax.random.split(k, 3)
        t_int = np.array(jax.random.randint(k_t, (bp,), 0, T + 1),
                         dtype=np.float32)
        noise = np.array(jax.random.normal(
            k_noise, (bp,) + lig.xh.shape[1:]))
        steps.append((tuple(np.array(a) for a in lig),
                      tuple(np.array(a) for a in poc), t_int, noise))
    spec = dict(T=T, egnn=EGNN, train=dict(batch_size=b, **TRAIN), world=world,
                lj_rm=lj, steps=steps, record=RECORD, state=state)
    return (world, spawn(ranks.train_rank, world, spec),
            ranks.train_rank(None, spec), jax_steps)


@pytest.mark.parametrize("after", RECORD)
def test_data_parallel_trainer_matches_jax_mesh(train_runs, after):
    """Rank 0 against JAX's mesh trainer and against the port's trainer in
    one process on the padded batch."""
    world, rank_steps, single, jax_steps = train_runs
    assert len(rank_steps) == world
    ours = rank_steps[0][after - 1]
    for ref_steps, kl_atol in ((jax_steps, KL_ATOL), (single, ATOL)):
        theirs = ref_steps[after - 1]
        for i in range(after):
            np.testing.assert_allclose(rank_steps[0][i]["loss"],
                                       ref_steps[i]["loss"], rtol=RTOL)
            mine, ref = rank_steps[0][i]["info"], ref_steps[i]["info"]
            assert sorted(mine) == sorted(ref)
            for k in ref:
                np.testing.assert_allclose(
                    mine[k], ref[k], rtol=RTOL,
                    atol=kl_atol if k == "kl_prior" else ATOL, err_msg=k)
        np.testing.assert_allclose(ours["buf"], theirs["buf"], rtol=RTOL)
        for name in ("params", "ema"):
            assert sorted(ours[name]) == sorted(theirs[name])
            for k, ref in theirs[name].items():
                np.testing.assert_allclose(ours[name][k], ref, rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {k}")
    assert ours["step"] == after and ours["count"] == after + 1
    # every rank holds rank 0's bits, and reports the same numbers
    for other in rank_steps[1:]:
        assert [s["loss"] for s in other] == [s["loss"] for s in rank_steps[0]]
        assert [s["info"] for s in other] == [s["info"] for s in rank_steps[0]]
        for name in ("params", "ema"):
            for k, v in ours[name].items():
                np.testing.assert_array_equal(other[after - 1][name][k], v)


# ---------------------------------------------------------------------------
# guided sampling
# ---------------------------------------------------------------------------

S_T, NL0, NP = 6, 8, 16
SAMPLER_EGNN = dict(hidden_nf=16, joint_nf=8, n_layers=1, row_tile=16,
                    attention=False, reflection_equivariant=True)
SPSA = dict(enabled=True, num_probes=2, start_step=4, every=2)
ATP = dict(enabled=True, num_groups=3, start_step=4, every=2)
SCOPES = {"global": (8, {}), "group_size": (12, dict(group_size=4)),
          "per_sample": (8, dict(per_sample=True))}


@pytest.fixture(scope="module")
def sampler_weights():
    module = JDynamics(jcfg.EGNNConfig(**SAMPLER_EGNN), atom_nf=NF,
                       residue_nf=NF)
    key = jax.random.PRNGKey(0)
    params = module.init(key, jnp.zeros((1, NL0, 13)),
                         jnp.zeros((1, NP, 13)), jnp.zeros((1,)),
                         jnp.ones((1, NL0)), jnp.ones((1, NP)))
    return module, params


@pytest.mark.parametrize("scope", list(SCOPES))
def test_data_parallel_guided_sampler(sampler_weights, scope):
    b, extra = SCOPES[scope]
    module, params = sampler_weights
    key = jax.random.PRNGKey(0)
    pocket = JBatch(
        x=jax.random.normal(key, (b, NP, 3)) * 2 + 5,
        h=jax.nn.one_hot(jax.random.randint(key, (b, NP), 0, 4), NF),
        mask=jnp.ones((b, NP)))
    sizes = np.full((b,), 6)
    core = jcore.CondDiffusion(jS.make_schedule("polynomial_2", S_T, 5e-4),
                               jcfg.DiffusionConfig(timesteps=S_T), NF, NF)
    jsc = jcfg.SampleConfig(spsa=jcfg.SPSAConfig(**SPSA),
                            atp=jcfg.ATPConfig(**ATP, **extra))
    sharded = JSampler(core, module, params, jsc, jparams["crossdock_full"],
                       mesh=make_mesh(n_data=2, devices=jax.devices()[:2]))
    run_key = jax.random.PRNGKey(9)
    ref = sharded.sample_given_pocket(run_key, pocket, sizes)

    cfg = SampleConfig(spsa=SPSAConfig(**SPSA), atp=ATPConfig(**ATP, **extra))
    nl = ref.ligand.x.shape[1]
    noise = jax_guided_noise(run_key, cfg, (b, nl, 3 + NF), S_T)
    spec = dict(
        T=S_T, egnn=SAMPLER_EGNN, spsa=SPSA, atp=dict(ATP, **extra),
        state={k: v.numpy() for k, v in params_from_jax(params).items()},
        pocket=tuple(np.array(a) for a in pocket), sizes=sizes,
        noise=dict(init=noise.init.numpy(), steps=noise.steps.numpy(),
                   decode=noise.decode.numpy(),
                   atp={s: v.numpy() for s, v in noise.atp.items()},
                   spsa={s: v.numpy() for s, v in noise.spsa.items()},
                   hybrid=tuple(v.numpy() for v in noise.hybrid)))
    single = ranks.sample_rank(None, spec)
    dp = spawn(ranks.sample_rank, 2, spec)

    mask = np.asarray(ref.ligand.mask)
    m = mask > 0.5
    forwards = count_forwards(cfg, S_T)
    assert single["forwards"] == forwards
    for out in (single, *dp):
        np.testing.assert_array_equal(out["mask"], mask)
        assert np.all(np.isfinite(out["x"]))
        np.testing.assert_allclose(out["x"], np.asarray(ref.ligand.x),
                                   rtol=0, atol=COORD_ATOL)
        np.testing.assert_allclose(out["x"], single["x"], rtol=0,
                                   atol=COORD_ATOL)
        np.testing.assert_array_equal(
            out["h"].argmax(-1)[m], np.asarray(ref.ligand.h).argmax(-1)[m])
        np.testing.assert_allclose(out["pocket_x"],
                                   np.asarray(ref.pocket.x), rtol=0,
                                   atol=COORD_ATOL)
        np.testing.assert_array_equal(out["row_src"], single["row_src"])
    # each rank made the forwards one process makes, on its rows; the
    # rows the ranks scored add up to one process's; every rank returns
    # the same whole batch
    assert [out["forwards"] for out in dp] == [forwards] * len(dp)
    assert sum(out["scored"] for out in dp) == single["scored"]
    np.testing.assert_array_equal(dp[1]["x"], dp[0]["x"])
    if scope == "per_sample":
        np.testing.assert_array_equal(single["row_src"], np.arange(b))


def test_data_parallel_sampler_draws_as_one_process(sampler_weights):
    """Without fixed noise the ranks draw every event's noise at the
    global shape from generators seeded alike, in the order one process
    draws it: the same ligands as one process with that generator."""
    _, params = sampler_weights
    b, seed = 8, 1
    rng = np.random.default_rng(seed)
    spec = dict(
        T=S_T, egnn=SAMPLER_EGNN, spsa=SPSA, atp=ATP, noise=None, seed=seed,
        state={k: v.numpy() for k, v in params_from_jax(params).items()},
        pocket=((rng.standard_normal((b, NP, 3)) * 2 + 5).astype(np.float32),
                np.eye(NF, dtype=np.float32)[rng.integers(0, 4, (b, NP))],
                np.ones((b, NP), np.float32)),
        sizes=np.full((b,), 6))
    single = ranks.sample_rank(None, spec)
    for out in spawn(ranks.sample_rank, 2, spec):
        np.testing.assert_array_equal(out["mask"], single["mask"])
        np.testing.assert_array_equal(out["row_src"], single["row_src"])
        np.testing.assert_allclose(out["x"], single["x"], rtol=0,
                                   atol=COORD_ATOL)
        m = single["mask"] > 0.5
        np.testing.assert_array_equal(out["h"].argmax(-1)[m],
                                      single["h"].argmax(-1)[m])


def test_rank_module_imports_no_jax():
    """A spawned rank imports torch_dp_ranks by name: it must start
    without JAX or the JAX package."""
    from test_torch_isolation import FORBIDDEN, imported_roots

    roots = set(imported_roots(ranks.__file__))
    assert "torch" in roots and not roots & FORBIDDEN


def test_spawn_fails_on_a_rank_that_raises_or_hangs():
    """A rank that raises fails the spawn with its rank; one that hangs
    fails it at the timeout; the other ranks are ended either way."""
    assert mesh.spawn(ranks.fail_on_rank, 2, "gloo", args=(-1, "raise"),
                      timeout=JOIN_TIMEOUT) == [0, 1]
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 exited"):
        mesh.spawn(ranks.fail_on_rank, 2, "gloo", args=(1, "raise"),
                   timeout=JOIN_TIMEOUT)
    with pytest.raises(TimeoutError, match="still running after 3"):
        mesh.spawn(ranks.fail_on_rank, 2, "gloo", args=(1, "hang"),
                   timeout=3.0)


def test_sampler_refuses_a_batch_the_ranks_do_not_split():
    group = mesh.DataGroup(rank=0, world=3, backend="gloo",
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        group.rows(8)
    assert group.rows(9) == slice(0, 3)


# ---------------------------------------------------------------------------
# the train CLI's ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Three micro-steps and the eval of the tiny CLI config, in one
    process and on two ranks, both resuming one seeded initial state."""
    root = tmp_path_factory.mktemp("torch_dp_cli")
    cfg = dict(CLI_CFG, n_epochs=1, auxiliary_loss=False)
    torch.manual_seed(0)
    model = DiffNDM(model_config_from_yaml(cfg), device="cpu")
    Trainer(model.core, model.dynamics, train_config_from_yaml(cfg)
            ).save_checkpoint(str(root / "init.npz"))
    runs = {}
    for label in ("one", "dp"):
        path = root / f"{label}.yml"
        with open(path, "w") as f:
            yaml.safe_dump(dict(cfg, logdir=str(root / label)), f)
        argv = ["--config", str(path), "--resume", str(root / "init.npz"),
                "--max_steps", "3", "--device", "cpu"]
        runs[label] = (train_cli.main(argv) if label == "one" else
                       mesh.spawn(ranks.cli_rank, 2, "gloo", args=(argv,),
                                  timeout=JOIN_TIMEOUT))
    return root, runs


def test_train_cli_ranks_match_one_process(cli_runs):
    root, runs = cli_runs
    one, dp = runs["one"], runs["dp"]
    assert len(dp) == 2 and dp[0]["steps"] == one["steps"] == 3
    for rank in dp:
        np.testing.assert_allclose(rank["train_losses"], one["train_losses"],
                                   rtol=RTOL)
        np.testing.assert_allclose(rank["val_losses"], one["val_losses"],
                                   rtol=RTOL)
    assert dp[1]["train_losses"] == dp[0]["train_losses"]
    outdir = root / "dp" / "smoke"
    assert sorted(os.listdir(outdir)) == sorted(
        os.listdir(root / "one" / "smoke"))
    lines = [json.loads(line) for line in open(outdir / "metrics.jsonl")]
    assert [r["split"] for r in lines] == ["train", "val"]
