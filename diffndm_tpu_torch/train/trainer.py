"""Training loop: AdamW with amsgrad, the adaptive gradient clip,
gradient accumulation, an EMA of the weights, ``.npz`` checkpoints.

The JAX package's ``train/trainer.py``, step for step, on one device or
data-parallel over a ``parallel.DataGroup``:

- the update is optax's ``chain(scale_by_amsgrad(), add_decayed_weights(
  weight_decay), scale_by_learning_rate(lr))``, written out here because
  ``torch.optim.AdamW(amsgrad=True)`` is another algorithm: optax keeps
  the maximum of the bias-corrected second moment, torch the maximum of
  the uncorrected one, corrected afterwards;
- accumulation follows ``optax.MultiSteps``: a running mean of the
  gradients over k micro-steps, the inner update on the k-th;
- the adaptive clip runs on every micro-step: threshold 1.5 * mean + 2 *
  std of a 50-entry buffer of accepted norms that starts at 3000.0 with
  count 1, written at ``step % 50`` (``step`` counts micro-steps);
- the EMA moves on every micro-step, also those that apply no update.

Each of these phases is one call over the list of leaves
(``ops/fused_optimizer``): on the card a few multi-tensor kernel launches
each, on the CPU the plain per-leaf loops.

A micro-step's parts are named spans on a profiler's timeline
(``utils.profiling``): ``forward``, ``backward``, under a group
``all_reduce``, ``optimizer`` (the clip, the update and the EMA) and
``readback`` (the loss and the ``info`` entries copied to the host).

With a learned noise schedule the trainer also trains its gamma network
(``gamma``), as the JAX trainer trains the tree ``{"dynamics", "gamma"}``:
one optimizer, one clip over the global norm of both, one EMA over both.

Under a group (the JAX trainer's mesh), ``train_step`` and ``eval_step``
take the global batch: it is repeat-padded to a multiple of the ranks as
JAX pads it, the draws (t and the noise) are made for the whole padded
batch, alike on every rank, and each rank takes its rows.  A rank's loss
is the sum of its rows' NLL over the global batch size; its gradients are
summed over the ranks in one flat all-reduce per micro-step (with the
loss and the ``info`` entries, which come back as JAX's global means), so
the clip, the optimizer and the EMA run on the same bits on every rank.
The parameters are rank 0's from the start (broadcast at construction and
by ``load_checkpoint``), and only rank 0 writes checkpoints.  The
``DistributedDataParallel`` wrapper would not do: its hooks do not see
``torch.autograd.grad``.

Checkpoints are ``.npz`` files with the JAX tree's flat key names
(``params/...``, ``ema_params/...``, ``step``; with a gamma network
``params/dynamics/...`` and ``params/gamma/...``), so ``convert.
params_from_jax`` and ``convert.gamma_params_from_jax`` read their
weights; as in JAX they hold no optimizer state, and a resume starts with
a fresh optimizer.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffndm_tpu_torch.config import TrainConfig
from diffndm_tpu_torch.convert import (gamma_params_from_jax,
                                       params_from_jax, params_to_jax,
                                       split_trees)
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.ops import fused_optimizer as FO
from diffndm_tpu_torch.parallel.mesh import (DataGroup, all_reduce_flat,
                                             pad_rows, replicate, shard_rows)
from diffndm_tpu_torch.structs import NodeBatch
from diffndm_tpu_torch.train.losses import (assemble_loss,
                                            conditional_loss_terms,
                                            draw_timesteps)
from diffndm_tpu_torch.utils.profiling import annotate

QUEUE_LEN = 50          # accepted gradient norms the clip looks back on
QUEUE_FLUSH = 3000.0    # the buffer's initial value


class AmsgradState:
    """optax's ``MultiSteps(chain(scale_by_amsgrad(), add_decayed_weights,
    scale_by_learning_rate))`` state for a list of parameters."""

    def __init__(self, params, cfg: TrainConfig):
        if not cfg.amsgrad:
            raise NotImplementedError("the port trains with amsgrad only")
        zeros = lambda: [torch.zeros_like(p) for p in params]
        self.cfg = cfg
        self.mu, self.nu, self.nu_max = zeros(), zeros(), zeros()
        self.acc = zeros()       # running mean of the micro-step gradients
        self.count = 0           # inner updates made
        self.mini_step = 0       # micro-steps into the current window

    @torch.no_grad()
    def update(self, params, grads) -> bool:
        """One micro-step: accumulate; on the k-th, update ``params`` in
        place.  Returns whether it updated."""
        k = max(1, self.cfg.accumulate_grad_batches)
        n = self.mini_step + 1
        state = (params, grads, self.acc, self.mu, self.nu, self.nu_max, n)
        if self.mini_step < k - 1:
            FO.amsgrad(*state, update=False)
            self.mini_step += 1
            return False
        self.count += 1
        cfg = self.cfg
        FO.amsgrad(*state, update=True, c1=1.0 - FO.B1 ** self.count,
                   c2=1.0 - FO.B2 ** self.count, lr=cfg.lr,
                   weight_decay=cfg.weight_decay)
        self.mini_step = 0
        return True


class Trainer:
    """Trains ``dynamics`` (an ``EGNNDynamics``) in place on the device
    its parameters lie on, and with it ``gamma``, the ``GammaNetwork`` of
    a learned schedule (the one ``core.schedule`` evaluates), when given.
    ``names`` / ``params`` are the dynamics', ``gamma_names`` /
    ``gamma_params`` the gamma network's (empty without one).
    ``group``: train data-parallel over its ranks, each holding a copy of
    the model on ``group.device``."""

    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module,
                 cfg: TrainConfig, lj_rm: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None,
                 gamma: Optional[torch.nn.Module] = None,
                 group: Optional[DataGroup] = None):
        self.core = core
        self.group = group
        self.module = dynamics
        self.gamma = gamma
        self.cfg = cfg
        self.names = [n for n, _ in dynamics.named_parameters()]
        self.params = [p for _, p in dynamics.named_parameters()]
        gamma_named = list(gamma.named_parameters()) if gamma else []
        self.gamma_names = [n for n, _ in gamma_named]
        self.gamma_params = [p for _, p in gamma_named]
        self.device = self.params[0].device
        self.lj_rm = (None if lj_rm is None else
                      torch.as_tensor(lj_rm, dtype=torch.float32,
                                      device=self.device))
        self.generator = generator
        if group is not None:
            replicate(group, self.trained)
        self.opt = AmsgradState(self.trained, cfg)
        self.step = 0
        self.gradnorm_buf = torch.full((QUEUE_LEN,), QUEUE_FLUSH,
                                       device=self.device)
        self.gradnorm_count = 1
        self.ema = [p.detach().clone() for p in self.trained]

    @property
    def trained(self):
        """Every trained parameter: the dynamics', then the gamma
        network's."""
        return self.params + self.gamma_params

    # -----------------------------------------------------------------
    def _loss(self, ligand: NodeBatch, pocket: NodeBatch, training: bool,
              t_int=None, noise=None, noise0=None, global_b=None):
        """The mean NLL and the info means; with ``global_b`` (a rank's
        rows of a global batch) the sums over these rows divided by it."""
        def eps_fn(z_lig, xh_pocket, t, lm, pm):
            return self.module(z_lig, xh_pocket, t, lm, pm)

        terms = conditional_loss_terms(self.core, eps_fn, ligand, pocket,
                                       training, t_int, noise, noise0,
                                       self.generator)
        nll, info = assemble_loss(terms, self.core, ligand, pocket,
                                  self.cfg, training, self.lj_rm)
        if global_b is None:
            return nll.mean(), info
        share = nll.shape[0] / global_b
        return nll.sum() / global_b, {k: v * share for k, v in info.items()}

    def _rank_rows(self, ligand: NodeBatch, pocket: NodeBatch,
                   training: bool, draws):
        """Under the group: the padded global batch, the draws made for
        all of it (those not given, in the order the loss draws them), and
        this rank's rows of both.  Returns (ligand, pocket, draws, global
        rows)."""
        group = self.group
        ligand, pocket = pad_rows(ligand, pocket, group.world)
        b, nl = ligand.x.shape[:2]
        draws = list(draws)
        if draws[0] is None:
            draws[0] = draw_timesteps(b, self.core.schedule.timesteps,
                                      training, self.generator, self.device)
        for i in range(1, len(draws)):
            if draws[i] is None:
                draws[i] = torch.randn(
                    (b, nl, 3 + ligand.h.shape[-1]),
                    generator=self.generator, device=self.device)
        draws = [torch.as_tensor(d).to(self.device) for d in draws]
        return (*shard_rows((ligand, pocket, draws), group.rank,
                            group.world), b)

    def _reduce(self, tensors, loss, info):
        """The sums over the ranks of ``tensors``, the loss and the info
        values, in one all-reduce; returns (tensors, loss, info)."""
        keys, n = list(info), len(tensors)
        out = all_reduce_flat(self.group, [*tensors, loss.detach(), *(
            info[k].detach().float() for k in keys)])
        return out[:n], out[n], dict(zip(keys, out[n + 1:]))

    def _clip(self, grads, info) -> None:
        """The gradients' global norm into ``info``; with the clip on, grads
        scaled in place by the adaptive clip and its threshold too."""
        clip = self.cfg.clip_grad
        gnorm, threshold = FO.clip_by_history(
            grads, self.gradnorm_buf, self.gradnorm_count,
            self.step % QUEUE_LEN, clip)
        info["grad_norm"] = gnorm
        if clip:
            info["clip_threshold"] = threshold
            self.gradnorm_count = min(self.gradnorm_count + 1, QUEUE_LEN)

    def train_step(self, ligand: NodeBatch, pocket: NodeBatch, t_int=None,
                   noise=None) -> Tuple[float, Dict[str, float]]:
        """One micro-step; draws what is not given from the generator.
        Under a group: the global batch, and draws (when given) for the
        padded global batch."""
        ligand, pocket = ligand.to(self.device), pocket.to(self.device)
        global_b = None
        if self.group is not None:
            ligand, pocket, (t_int, noise), global_b = self._rank_rows(
                ligand, pocket, True, (t_int, noise))
        self.module.train()
        with torch.enable_grad():
            with annotate("forward"):
                loss, info = self._loss(ligand, pocket, True, t_int, noise,
                                        global_b=global_b)
            # parameters the loss does not reach (the pocket's decoder in
            # the conditional model) get a zero gradient, as in JAX
            with annotate("backward"):
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(self.trained, torch.autograd.grad(
                             loss, self.trained, allow_unused=True))]
        if self.group is not None:
            with annotate("all_reduce"):
                grads, loss, info = self._reduce(grads, loss, info)
        with torch.no_grad(), annotate("optimizer"):
            self._clip(grads, info)
            self.apply_gradients(grads)
        with annotate("readback"):
            return float(loss.detach()), {k: float(v.detach())
                                          for k, v in info.items()}

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        """The rest of a micro-step after the clip: the optimizer (an
        update on every k-th call), the EMA, the step count."""
        self.opt.update(self.trained, grads)
        FO.ema(self.ema, self.trained, self.cfg.ema_decay)
        self.step += 1

    @torch.no_grad()
    def eval_step(self, ligand: NodeBatch, pocket: NodeBatch, t_int=None,
                  noise=None, noise0=None) -> Tuple[float, Dict[str, float]]:
        """The VLB loss with the current (raw) parameters; under a group
        as ``train_step`` takes its batch and draws."""
        ligand, pocket = ligand.to(self.device), pocket.to(self.device)
        global_b = None
        if self.group is not None:
            ligand, pocket, (t_int, noise, noise0), global_b = \
                self._rank_rows(ligand, pocket, False, (t_int, noise, noise0))
        self.module.eval()
        loss, info = self._loss(ligand, pocket, False, t_int, noise, noise0,
                                global_b=global_b)
        if self.group is not None:
            _, loss, info = self._reduce([], loss, info)
        return float(loss), {k: float(v) for k, v in info.items()}

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The dynamics' EMA weights under the module's parameter names."""
        return dict(zip(self.names, self.ema))

    def gamma_ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The gamma network's EMA weights (empty without one)."""
        return dict(zip(self.gamma_names, self.ema[len(self.params):]))

    # -- checkpoints ----------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """``path`` (``.npz`` appended if missing): params, step and, with
        an EMA, ema_params, under the JAX tree's flat names.  Under a
        group only rank 0 writes."""
        if self.group is not None and self.group.rank != 0:
            return
        out = {"step": np.asarray(self.step, dtype=np.int32)}
        trees = [("params", self.trained)]
        if self.cfg.ema_decay > 0.0:
            trees.append(("ema_params", self.ema))
        n_dyn = len(self.params)
        for prefix, tensors in trees:
            parts = [("", self.names, tensors[:n_dyn])]
            if self.gamma is not None:
                parts = [("dynamics/", self.names, tensors[:n_dyn]),
                         ("gamma/", self.gamma_names, tensors[n_dyn:])]
            for sub, names, values in parts:
                state = {n: t.detach().cpu() for n, t in zip(names, values)}
                for key, value in params_to_jax(state).items():
                    out[f"{prefix}/{sub}{key}"] = value
        path = path if path.endswith(".npz") else path + ".npz"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path[:-4] + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """params, step and ema_params (the params where a file has
        none); the optimizer state is not restored.  Under a group every
        rank ends with rank 0's."""
        params, ema, step = load_train_state(path)
        self._assign(self.trained, params)
        self._assign(self.ema, ema if ema is not None else params)
        self.step = step
        if self.group is not None:
            replicate(self.group, self.trained + self.ema)

    def _assign(self, targets, tree) -> None:
        dyn, gamma = split_trees(tree)
        if (gamma is None) != (self.gamma is None):
            raise ValueError("the checkpoint's gamma tree does not match the "
                             "schedule")
        state = params_from_jax(dyn)
        if gamma is not None:
            state.update({"gamma." + k: v for k, v in
                          gamma_params_from_jax(gamma).items()})
        names = self.names + ["gamma." + n for n in self.gamma_names]
        if sorted(state) != sorted(names):
            raise ValueError("checkpoint parameters do not match the model")
        with torch.no_grad():
            for name, t in zip(names, targets):
                t.copy_(state[name])


def load_train_state(path: str):
    """(params tree, ema_params tree or None, step) of a training
    checkpoint ``.npz``; the trees are flat, with the JAX names."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    trees = {"params": {}, "ema_params": {}}
    for key, value in flat.items():
        head, _, rest = key.partition("/")
        if head in trees:
            trees[head][rest] = value
    if not trees["params"]:
        raise ValueError(f"{path}: no params in the checkpoint")
    return (trees["params"], trees["ema_params"] or None,
            int(flat["step"]))
