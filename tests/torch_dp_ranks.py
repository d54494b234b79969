"""Rank functions of ``test_torch_parallel.py``.

``parallel.mesh.spawn`` runs them in new processes, which import this
module by name; it imports torch, numpy and the port only, so a rank
starts without JAX.  Each rank runs on one thread.  ``group=None`` runs
the same code in one process.
"""

import numpy as np
import torch

ATOM_NF = 10


def _batch(arrays):
    from diffndm_tpu_torch.structs import NodeBatch

    return NodeBatch(*(torch.from_numpy(np.asarray(a)) for a in arrays))


def _core(T):
    from diffndm_tpu_torch.config import DiffusionConfig
    from diffndm_tpu_torch.diffusion import schedules as S
    from diffndm_tpu_torch.diffusion.core import CondDiffusion

    return CondDiffusion(S.make_schedule("polynomial_2", T, 5e-4),
                         DiffusionConfig(timesteps=T), ATOM_NF, ATOM_NF)


def _dynamics(egnn_kw, state):
    from diffndm_tpu_torch.config import EGNNConfig
    from diffndm_tpu_torch.models.dynamics import EGNNDynamics

    dyn = EGNNDynamics(EGNNConfig(**egnn_kw), ATOM_NF, ATOM_NF)
    dyn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return dyn


def _snapshot(trainer):
    from diffndm_tpu_torch.convert import params_to_jax

    return dict(
        params=params_to_jax(dict(zip(trainer.names, trainer.params))),
        ema=params_to_jax(dict(zip(trainer.names, trainer.ema))),
        buf=trainer.gradnorm_buf.numpy().copy(),
        count=trainer.gradnorm_count, step=trainer.step)


def train_rank(group, spec):
    """Micro-steps of the port's Trainer on spec's batches and draws (the
    draws for the batch padded to ``spec["world"]`` ranks; in one process
    the batch is padded here); returns per step the loss and info, and
    after the steps in ``spec["record"]`` the state."""
    torch.set_num_threads(1)
    from diffndm_tpu_torch.config import TrainConfig
    from diffndm_tpu_torch.parallel.mesh import pad_rows
    from diffndm_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_core(spec["T"]), _dynamics(spec["egnn"],
                                                  spec["state"]),
                      TrainConfig(**spec["train"]), lj_rm=spec["lj_rm"],
                      group=group)
    steps = []
    for i, (lig, poc, t_int, noise) in enumerate(spec["steps"]):
        lig, poc = _batch(lig), _batch(poc)
        if group is None:
            lig, poc = pad_rows(lig, poc, spec["world"])
        loss, info = trainer.train_step(lig, poc, torch.from_numpy(t_int),
                                        torch.from_numpy(noise))
        rec = dict(loss=loss, info=info)
        if i + 1 in spec["record"]:
            rec.update(_snapshot(trainer))
        steps.append(rec)
    return steps


def sample_rank(group, spec):
    """One guided ``sample_given_pocket`` of the global pocket batch under
    spec's fixed noise (or, without it, drawing from a generator seeded
    with ``spec["seed"]``); returns the whole result, the forwards this
    process made and its oracle's scored rows."""
    torch.set_num_threads(1)
    from diffndm_tpu_torch.config import ATPConfig, SampleConfig, SPSAConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,
                                                     SamplerNoise)
    from diffndm_tpu_torch.guidance.oracle import RewardOracle

    dyn = _dynamics(spec["egnn"], spec["state"])
    forwards = []
    dyn.register_forward_hook(lambda *a: forwards.append(1))
    cfg = SampleConfig(spsa=SPSAConfig(**spec["spsa"]),
                       atp=ATPConfig(**spec["atp"]))
    oracle = RewardOracle(dataset_params["crossdock_full"], scorer="native")
    sampler = ConditionalSampler(_core(spec["T"]), dyn, cfg, oracle,
                                 group=group)
    n, noise, generator = spec["noise"], None, None
    if n is None:       # every draw from a generator seeded alike
        generator = torch.Generator().manual_seed(spec["seed"])
    else:
        noise = SamplerNoise(
            *(torch.from_numpy(n[k]) for k in ("init", "steps", "decode")),
            atp={s: torch.from_numpy(v) for s, v in n["atp"].items()},
            spsa={s: torch.from_numpy(v) for s, v in n["spsa"].items()},
            hybrid=tuple(torch.from_numpy(v) for v in n["hybrid"]))
    out = sampler.sample_given_pocket(_batch(spec["pocket"]), spec["sizes"],
                                      timesteps=spec["T"], noise=noise,
                                      generator=generator)
    return dict(x=out.ligand.x.numpy(), h=out.ligand.h.numpy(),
                mask=out.ligand.mask.numpy(), pocket_x=out.pocket.x.numpy(),
                row_src=out.row_src.numpy(), forwards=len(forwards),
                scored=oracle.n_scored)


def cli_rank(group, argv):
    """A rank of the train CLI (``cli.train.run``) on ``argv``."""
    torch.set_num_threads(1)
    from diffndm_tpu_torch.cli import train as train_cli

    return train_cli._train_rank(group, argv)


def fail_on_rank(group, bad_rank, how):
    """Rank ``bad_rank`` raises (``how="raise"``) or hangs (``"hang"``);
    the others return their rank."""
    import time

    if group.rank == bad_rank:
        if how == "raise":
            raise RuntimeError("a fault on purpose")
        time.sleep(600)
    return group.rank
