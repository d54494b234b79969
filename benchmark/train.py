"""Training cells: micro-steps of ``Trainer.train_step`` (forward,
backward, the clip, the accumulated AdamW-amsgrad update and the EMA)
back to back, as ``cli/train.py`` drives it, for the window's length.

Set-up builds one trainer on the model with the configuration's weights,
makes a pool of synthetic ligand-pocket pairs (``traffic.synthetic_pairs``,
fixed by the traffic's seed) and drives the trainer through its first
micro-steps with the window's own feed: each takes ``rows`` pairs in an
order drawn from the run's seed, its time steps and noise drawn on the
card from the run's seed.  The loss of each, the gradients as the
optimizer holds them after the first, and the weights after the last are
kept; the same trainer then runs the window.  Inside the window one
accumulation window of micro-steps, drawn from the seed after the traced
ones, is kept too: the trainer's state before it (weights, moments, the
clip's buffer of norms), its feed, its losses, the gradient as the
optimizer holds it after its first micro-step and the weights after its
update.  Once the window has closed the reference
(``reference/train.py``) follows those first micro-steps from the same
weights and feed, and the window's micro-steps from the trainer's state
before them (``check``).  With ``--trace 1`` a few micro-steps are
profiled, and every forward's inputs are kept to count the edges they
need.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import costs
from benchmark import traffic as TR
from benchmark import weights as W
from benchmark.harness import Cell, Run
from benchmark.reference import diffusion as RD
from benchmark.reference import train as RT
from benchmark.reference.egnn import Reference
from benchmark.sample import sync
from benchmark.trace import Recorder


class TrainSetup:
    def __init__(self, cell: Cell, device):
        from diffndm_tpu_torch.config import (model_config_from_yaml,
                                              train_config_from_yaml)
        from diffndm_tpu_torch.model import DiffNDM
        from diffndm_tpu_torch.train.trainer import Trainer

        tr, cfg = cell.traffic, cell.config
        self.cell, self.device = cell, torch.device(device)
        self.hp = cfg["hparams"]["egnn_params"]
        self.model_cfg = model_config_from_yaml(cfg["hparams"])
        self.train_cfg = train_config_from_yaml(cfg["hparams"])
        self.atom_nf = self.model_cfg.atom_nf
        self.norm = tuple(self.model_cfg.diffusion.norm_values)
        self.timesteps = self.model_cfg.diffusion.timesteps
        model = DiffNDM(self.model_cfg, device=self.device)
        w = cfg["weights"]
        self.weights = W.seeded(self.hp, self.atom_nf,
                                self.model_cfg.residue_nf, w["seed"],
                                self.device, w)
        model.set_params(W.program_state(self.weights))
        self.trainer = Trainer(model.core, model.dynamics, self.train_cfg)
        pairs = tr["pairs"]
        arrays = TR.synthetic_pairs(pairs["seed"], pairs["pool"],
                                    pairs["pocket"], pairs["ligand"])
        self.pool = [torch.from_numpy(a).to(self.device) for a in arrays]
        self.rows = int(tr["rows"])
        self.order = TR.rng(cell.seed, 5).permutation(pairs["pool"])
        self.gen = TR.device_generator(cell.seed, 6, self.device)

    def feed(self, j: int):
        """Micro-step j's rows: pairs, time steps and noise."""
        p = len(self.order)
        idx = torch.as_tensor(self.order[(np.arange(self.rows) + j * self.rows)
                                         % p], device=self.device)
        x_l, h_l, x_p, h_p = (a.index_select(0, idx) for a in self.pool)
        t = torch.randint(0, self.timesteps + 1, (self.rows,),
                          generator=self.gen, device=self.device)
        noise = torch.randn((self.rows,) + x_l.shape[1:2]
                            + (3 + self.atom_nf,), generator=self.gen,
                            device=self.device)
        lm = torch.ones(x_l.shape[:2], device=self.device)
        pm = torch.ones(x_p.shape[:2], device=self.device)
        return (x_l, h_l, lm, x_p, h_p, pm, t, noise)

    def state(self) -> Dict[str, list]:
        """Copies of the trainer's state that the reference resumes from:
        the weights, the optimizer's moments, the clip's buffer."""
        t = self.trainer
        copy = lambda ts: [v.detach().clone() for v in ts]
        return dict(params=copy(t.params), mu=copy(t.opt.mu),
                    nu=copy(t.opt.nu), nu_max=copy(t.opt.nu_max),
                    norms=t.gradnorm_buf.detach().clone())

    def micro_step(self, batch) -> float:
        from diffndm_tpu_torch.structs import NodeBatch

        x_l, h_l, lm, x_p, h_p, pm, t, noise = batch
        loss, _ = self.trainer.train_step(NodeBatch(x_l, h_l, lm),
                                          NodeBatch(x_p, h_p, pm),
                                          t_int=t, noise=noise)
        return loss


def run(cell: Cell, device, t_process: float) -> Run:
    device = torch.device(device)
    s = TrainSetup(cell, device)
    tr = cell.traffic
    n_check = int(tr["check"]["steps"])
    # the first micro-steps: the check's, and the warm-up of every shape
    # (forward, backward, an update)
    batches, losses = [], []
    for j in range(n_check):
        batches.append(s.feed(j))
        losses.append(s.micro_step(batches[-1]))
        if j == 0:
            first = [a.detach().clone() for a in s.trainer.opt.acc]
    after = [p.detach().clone() for p in s.trainer.params]
    names = list(s.trainer.names)
    recorder = None
    if cell.trace:
        Recorder.warm()
        recorder = Recorder()
    records = []

    def pre(module, args):
        records.append((args[0], args[1], args[3], args[4],
                        recorder is not None and recorder.active))

    hook = s.trainer.module.register_forward_pre_hook(pre) \
        if cell.trace else None
    trace_at = tr["trace"]["first_step"]
    trace_end = trace_at + tr["trace"]["steps"]
    k = max(1, s.train_cfg.accumulate_grad_batches)
    w_at = window_group(cell.seed, n_check + trace_end, k,
                        int(tr["check"]["window_groups"]))
    kept = dict(batches=[], losses=[])
    sync(device)
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    deadline = t_start + cell.seconds
    j, done = n_check, 0
    while time.perf_counter() < deadline:
        if recorder is not None:
            if done == trace_at:
                recorder.start()
            elif done == trace_end:
                recorder.stop()
        batch = s.feed(j)
        if j == w_at:
            kept["before"] = s.state()
        loss = s.micro_step(batch)
        if w_at <= j < w_at + k:
            kept["batches"].append(batch)
            kept["losses"].append(loss)
            if j == w_at:
                kept["first"] = [a.detach().clone() for a in s.trainer.opt.acc]
            if j == w_at + k - 1:
                kept["after"] = [p.detach().clone() for p in s.trainer.params]
        j += 1
        done += 1
    sync(device)
    t_end = time.perf_counter()
    if "after" not in kept:
        raise RuntimeError(f"the window closed before micro-step "
                           f"{w_at + k - 1}, the last one checked")
    if recorder is not None and recorder.active:
        recorder.stop()
    if hook is not None:
        hook.remove()
    out = Run(cell=cell, setup_s=setup_s, window_s=t_end - t_start)
    out.work["samples"] = float(s.rows * done)
    out.attempted = s.rows * done
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if cell.trace:
        _trace_costs(out, s, records, recorder, t_end - t_start)
    s.trainer = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    as_ref = lambda ts: W.from_program(dict(zip(names, ts)), s.weights)
    prog = dict(losses=losses, first=as_ref(first), after=as_ref(after))
    before = {key: as_ref(v) for key, v in kept["before"].items()
              if key != "norms"}
    window = dict(at=w_at, batches=kept["batches"], before=before,
                  norms=kept["before"]["norms"],
                  prog=dict(losses=kept["losses"], first=as_ref(kept["first"]),
                            after=as_ref(kept["after"])))
    out.checks = check(s, cell, batches, prog, window, cell.control)
    return out


def window_group(seed: int, earliest: int, k: int, groups: int) -> int:
    """The first micro-step of the accumulation window the check follows
    inside the timed window: one of the ``groups`` windows from the first
    that starts at or after micro-step ``earliest``, drawn from the
    seed."""
    first = -(-earliest // k) * k
    return first + k * int(TR.rng(seed, 7).integers(groups))


def _trace_costs(out: Run, s, records, recorder, window_s: float) -> None:
    """The traced part's least kernel time and the untraced part's model
    FLOPs and host clock (``costs.window_costs``)."""
    peak = costs.peaks(torch.cuda.get_device_name(0)) if \
        s.device.type == "cuda" else None
    least, out.traced_steps, out.untraced_flops = costs.window_costs(
        records, s.hp, peak, backward=True)
    out.bwd_least_s = least
    out.trace = recorder.summary
    out.untraced_s = window_s - recorder.host_s
    if peak is not None:
        out.peak_flops = peak[costs.PRECISION_PEAK[
            s.hp.get("compute_dtype", "float32")]]


def _follow(s: TrainSetup, batches, matmul: str, block: int,
            window: Optional[dict] = None):
    """The reference's micro-steps on ``batches``: from the
    configuration's weights and a fresh optimizer, or with ``window``
    from the trainer's state before the window's micro-steps."""
    start = s.weights if window is None else window["before"]["params"]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    ref = Reference(leaves, s.hp, matmul, block)
    dp = s.cell.config["hparams"]["diffusion_params"]
    gamma = torch.as_tensor(RD.gamma_table(
        dp["diffusion_noise_schedule"], s.timesteps,
        dp["diffusion_noise_precision"]), device=s.device)
    cfg = s.train_cfg
    opt = RT.Optimizer(leaves, cfg.lr, cfg.weight_decay,
                       cfg.accumulate_grad_batches, cfg.clip_grad)
    if window is not None:
        b = window["before"]
        opt.resume(b["mu"], b["nu"], b["nu_max"], window["norms"],
                   window["at"])
    return RT.follow(ref, leaves, gamma, batches, s.norm, s.atom_nf, opt,
                     block)


def readings(side: Dict, ref, w0: Dict[str, torch.Tensor]
             ) -> Dict[str, float]:
    """The numbers compared: the worst micro-step's relative loss gap; the
    worst leaf's gap of the first gradient's norm; the median leaf's gap
    of the weights' change from ``w0`` over the micro-steps, among the
    leaves whose reference gradient reaches a thousandth of the median
    leaf's (the others move by round-off alone).  The first amsgrad update
    is about -lr * sign(g) per entry, so an entry whose gradient is near
    the update's epsilon swings its leaf's norm with the last bits of g:
    the worst leaf reads that noise, the median leaf the update."""
    r_losses, r_first, r_after = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                       r_losses))
    grad_gap = max(RT.leaf_gaps(side["first"], r_first).values())
    norms = {k: float(v.norm()) for k, v in r_first.items()}
    med = sorted(norms.values())[len(norms) // 2]
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    changes = RT.leaf_gaps({k: side["after"][k] - w0[k] for k in keep},
                           {k: r_after[k] - w0[k] for k in keep})
    change_gap = sorted(changes.values())[len(changes) // 2]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def check(s: TrainSetup, cell: Cell, batches, prog, window, control: bool):
    """The set-up's first micro-steps' numbers, and under ``window.`` the
    window's accumulation window's, against their limits; with
    ``control`` also those of the reference in TF32 in the program's
    place."""
    lim = cell.traffic["check"]["limits"]
    block = cell.traffic["check"]["block_rows"]
    parts = (("", batches, prog, None, s.weights),
             ("window.", window["batches"], window["prog"], window,
              window["before"]["params"]))
    out = {}
    for prefix, feed, side, resume, w0 in parts:
        ref = _follow(s, feed, "fp32", block, resume)
        for k, v in readings(side, ref, w0).items():
            out[prefix + k] = {"value": v, "limit": lim[prefix + k]}
        if control:
            low = _follow(s, feed, "tf32", block, resume)
            ctl = dict(losses=low[0], first=low[1], after=low[2])
            for k, v in readings(ctl, ref, w0).items():
                out["control." + prefix + k] = {"value": v,
                                                "limit": lim[prefix + k]}
    return out
