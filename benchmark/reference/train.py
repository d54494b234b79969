"""Plain reference of DiffSBDD's conditional training step (arXiv:
2210.13695, ``lightning_modules.py`` with ``conditional_model.py``): the
L2 training loss of a batch, its gradients, the adaptive gradient clip,
gradient accumulation and the AdamW-with-amsgrad update, in plain
PyTorch and float32.

It imports nothing of the program.  The update is optax's
``MultiSteps(chain(scale_by_amsgrad(), add_decayed_weights(wd),
scale_by_learning_rate(lr)))``, the exported model's optimizer: the
maximum is taken of the bias-corrected second moment.  The clip is the
reference's: the threshold 1.5 * mean + 2 * std of a 50-entry buffer of
accepted norms, which starts at 3000 with a count of 1.

The gradients are summed over blocks of rows (each row is its own graph,
so the batch mean splits by rows) to hold the dense edge tensors' memory.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference.diffusion import ligand_com_free
from benchmark.reference.egnn import Reference

B1, B2, EPS = 0.9, 0.999, 1e-8
QUEUE_LEN, QUEUE_FLUSH = 50, 3000.0


def _b(v):
    return v.reshape(-1, 1, 1)


def nll_rows(ref: Reference, gamma: torch.Tensor, x_lig, h_lig, lm, x_poc,
             h_poc, pm, t_int, noise, norm_values, atom_nf):
    """The L2 training loss of each row [B]: 0.5 |eps - eps_hat|^2 over
    the ligand's (3 + atom_nf) N entries at t > 0, the t = 0 likelihood
    terms at t = 0, plus the prior's KL."""
    nx, nh = norm_values
    T = gamma.shape[0] - 1
    ml, mp = lm[..., None], pm[..., None]
    n = lm.sum(1)
    xl, xp = ligand_com_free(x_lig / nx * ml, x_poc / nx * mp, lm, pm)
    xh0 = torch.cat([xl, h_lig / nh * ml], -1)
    hp = h_poc / nh * mp
    t = t_int.float()
    gt = gamma[t_int.long()]
    a_t, s_t = torch.sqrt(torch.sigmoid(-gt)), torch.sqrt(torch.sigmoid(gt))
    eps = noise * ml
    z = _b(a_t) * xh0 + _b(s_t) * eps
    zx, pxz = ligand_com_free(z[..., :3], xp, lm, pm)
    z = torch.cat([zx, z[..., 3:]], -1)
    net = ref.eps_rows(z, torch.cat([pxz, hp], -1), t / T, lm, pm)
    sq = (eps - net) ** 2
    error = (sq * ml).sum((1, 2))
    t0 = (t_int == 0).float()
    loss_t = 0.5 * error / ((3.0 + atom_nf) * n) * (1.0 - t0)
    # t = 0: the Gaussian likelihood of x and the discretised one of h
    log_p_x = -0.5 * ((sq[..., :3]) * ml).sum((1, 2))
    sig0 = _b(s_t) * nh
    centered = z[..., 3:] * nh - 1.0

    def cdf(v):
        return 0.5 * (1.0 + torch.erf(v / math.sqrt(2)))

    diff = cdf((centered + 0.5) / sig0) - cdf((centered - 0.5) / sig0)
    log_ph = torch.log(diff.clamp_min(0.0) + 1e-10)
    log_probs = log_ph - torch.logsumexp(log_ph, -1, keepdim=True)
    log_p_h = (log_probs * h_lig * ml).sum((1, 2))
    loss_0 = (-log_p_x / (3.0 * n) - log_p_h) * t0
    # KL(q(z_T | x) || N(0, 1)), the coordinates in the (N - 1) * 3
    # dimensional centre-of-mass-free subspace, the types as one
    gT = gamma[T]
    a_T, s_T = torch.sqrt(torch.sigmoid(-gT)), torch.sqrt(torch.sigmoid(gT))
    mu = a_T * xh0

    def kl(mu2, d):
        return d * torch.log(1.0 / s_T) + 0.5 * (d * s_T ** 2 + mu2) - 0.5 * d

    kl_prior = (kl(((mu[..., 3:] ** 2) * ml).sum((1, 2)), 1.0)
                + kl(((mu[..., :3] ** 2) * ml).sum((1, 2)), (n - 1) * 3))
    return loss_t + loss_0 + kl_prior


def loss_and_grads(ref: Reference, leaves: Dict[str, torch.Tensor], gamma,
                   batch, norm_values, atom_nf, block: int):
    """(mean loss, {name: gradient}) of one micro-step over ``batch`` =
    (x_lig, h_lig, lm, x_poc, h_poc, pm, t_int, noise), in row blocks."""
    for v in leaves.values():
        v.grad = None
    b = batch[0].shape[0]
    total = 0.0
    for i in range(0, b, block):
        rows = [v[i:i + block] for v in batch]
        nll = nll_rows(ref, gamma, *rows, norm_values, atom_nf)
        (nll.sum() / b).backward()
        total += float(nll.detach().sum())
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total / b, grads


class Optimizer:
    """The clip, the accumulation and the amsgrad update over a dict of
    leaves (updated in place)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, accumulate: int, clip: bool):
        self.leaves, self.lr, self.wd = leaves, lr, weight_decay
        self.k, self.clip = max(1, accumulate), clip
        zeros = lambda: {n: torch.zeros_like(v) for n, v in leaves.items()}
        self.mu, self.nu, self.nu_max, self.acc = zeros(), zeros(), zeros(), \
            zeros()
        self.count = self.mini = self.step = 0
        dev = next(iter(leaves.values())).device
        self.buf = torch.full((QUEUE_LEN,), QUEUE_FLUSH, device=dev,
                              dtype=torch.float64)
        self.buf_count = 1

    @torch.no_grad()
    def resume(self, mu, nu, nu_max, norms: torch.Tensor,
               micro_steps: int) -> None:
        """Continue from another run's state at the start of an
        accumulation window, ``micro_steps`` micro-steps in: its moments
        and its buffer of accepted gradient norms; the counts follow from
        ``micro_steps``."""
        if micro_steps % self.k:
            raise ValueError("resume at the start of an accumulation window")
        for mine, theirs in ((self.mu, mu), (self.nu, nu),
                             (self.nu_max, nu_max)):
            for k in mine:
                mine[k] = theirs[k].detach().clone()
        self.acc = {k: torch.zeros_like(v) for k, v in self.acc.items()}
        self.count, self.mini, self.step = micro_steps // self.k, 0, \
            micro_steps
        self.buf = norms.detach().to(torch.float64).clone()
        self.buf_count = min(1 + micro_steps, QUEUE_LEN)

    @torch.no_grad()
    def micro_step(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip:
            gnorm = torch.sqrt(sum((g.double() ** 2).sum()
                                   for g in grads.values()))
            cnt = self.buf_count
            valid = self.buf[:cnt]
            mean = valid.mean()
            std = torch.sqrt(((valid - mean) ** 2).mean())
            max_norm = 1.5 * mean + 2.0 * std
            scale = float(torch.clamp(max_norm / (gnorm + 1e-12), max=1.0))
            grads = {k: g * scale for k, g in grads.items()}
            self.buf[self.step % QUEUE_LEN] = torch.minimum(gnorm, max_norm)
            self.buf_count = min(cnt + 1, QUEUE_LEN)
        n = self.mini + 1
        for k, g in grads.items():
            self.acc[k] += (g - self.acc[k]) / n
        self.step += 1
        if self.mini < self.k - 1:
            self.mini += 1
            return
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for k, p in self.leaves.items():
            g = self.acc[k]
            self.mu[k] = B1 * self.mu[k] + (1.0 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1.0 - B2) * g * g
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / c2)
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu_max[k]) + EPS)
            if self.wd:
                u = u + self.wd * p
            p.sub_(self.lr * u)
            self.acc[k].zero_()
        self.mini = 0


def follow(ref: Reference, leaves, gamma, batches: List[tuple], norm_values,
           atom_nf, opt: Optimizer, block: int):
    """The reference's first micro-steps on ``batches``.  Returns the
    losses, the gradients as the optimizer holds them after the first
    (clipped), and the leaves after the last."""
    losses, first = [], None
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(ref, leaves, gamma, batch, norm_values,
                                     atom_nf, block)
        losses.append(loss)
        opt.micro_step(grads)
        if i == 0:
            first = {k: v.clone() for k, v in opt.acc.items()}
    return losses, first, {k: v.detach().clone() for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
    """Each leaf's gap of norms, | |p| - |r| |, over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in ref}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: abs(float(prog[k].double().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in ref}
