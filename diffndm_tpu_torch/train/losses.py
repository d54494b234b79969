"""Training losses of the conditional and the joint DDPM over padded
batches.

The JAX package's ``train/losses.py``: the diffusion terms of one batch
(``conditional_loss_terms``, and ``joint_loss_terms`` for the joint
model), the L2 / VLB assembly (``assemble_loss``), the intra-ligand
Lennard-Jones auxiliary term and its weight schedule.  Torch cannot replay
JAX's threefry streams, so the draws (the timestep ``t_int``, the noise
and the t = 0 noise of the eval loss) are arguments; what is not given is
drawn from ``generator``.  The trainer trains with the conditional terms,
as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from diffndm_tpu_torch.config import TrainConfig
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.core import CondDiffusion, EpsFn, _b11
from diffndm_tpu_torch.diffusion.joint import JointDiffusion, JointDraw
from diffndm_tpu_torch.ops.segment import (masked_mean, remove_mean_joint,
                                           remove_mean_ligand,
                                           sum_except_batch)
from diffndm_tpu_torch.structs import NodeBatch


def draw_timesteps(b: int, timesteps: int, training: bool,
                   generator: Optional[torch.Generator] = None,
                   device="cpu") -> torch.Tensor:
    """t ~ U{0 (training) or 1 (eval), ..., T}, [B] float32."""
    lowest = 0 if training else 1
    return torch.randint(lowest, timesteps + 1, (b,), generator=generator,
                         device=device).float()


def conditional_loss_terms(core: CondDiffusion, eps_fn: EpsFn,
                           ligand: NodeBatch, pocket: NodeBatch,
                           training: bool, t_int=None, noise=None,
                           noise0=None, generator=None
                           ) -> Dict[str, torch.Tensor]:
    """All NLL terms of a batch.  t_int: [B] steps (0..T in training,
    1..T in eval); noise / noise0: [B, NL, 3 + atom_nf] standard normal,
    the q(z_t | x) noise and (eval only) the noise of the t = 0 term."""
    b = ligand.x.shape[0]
    dev = ligand.x.device
    T = core.schedule.timesteps
    lm, pm = ligand.mask, pocket.mask
    lig_size = ligand.size
    nd = core.n_dims

    xh0_lig = core.normalize_xh(torch.cat([ligand.x, ligand.h], -1), lm)
    xh0_pocket = core.normalize_xh(torch.cat([pocket.x, pocket.h], -1), pm)
    delta_log_px = (-core.subspace_dimensionality(lig_size)
                    * math.log(core.cfg.norm_values[0]))

    if t_int is None:
        t_int = draw_timesteps(b, T, training, generator, dev)
    t_int = torch.as_tensor(t_int, device=dev).float()
    t_is_zero = (t_int == 0).float()
    gamma_s = core.schedule((t_int - 1) / T)
    gamma_t = core.schedule(t_int / T)

    if core.simple:
        # the simple variant: both parts less the pocket's centre of mass
        com = masked_mean(xh0_pocket[..., :nd], pm, dim=1, keepdim=True)
        lx = (xh0_lig[..., :nd] - com) * lm[..., None]
        px = (xh0_pocket[..., :nd] - com) * pm[..., None]
    else:
        lx, px = remove_mean_ligand(xh0_lig[..., :nd],
                                    xh0_pocket[..., :nd], lm, pm)
    xh0_lig = torch.cat([lx, xh0_lig[..., nd:]], -1)
    xh0_pocket = torch.cat([px, xh0_pocket[..., nd:]], -1)

    z_t_lig, xh_pocket, eps_lig = core.noised_representation(
        xh0_lig, xh0_pocket, lm, pm, gamma_t, noise, generator)
    net_lig, _ = eps_fn(z_t_lig, xh_pocket, t_int / T, lm, pm)
    xh_lig_hat = core.xh_given_zt_and_epsilon(z_t_lig, net_lig, gamma_t)

    sq = (eps_lig - net_lig) ** 2
    vidx = core.cfg.virtual_node_idx
    if vidx is not None:
        keep = 1.0 - xh0_lig[..., nd + vidx]
        sq = torch.cat([sq[..., :nd] * keep[..., None], sq[..., nd:]], -1)
    error_t_lig = sum_except_batch(sq, lm)

    snr_weight = 1.0 - S.snr(gamma_s - gamma_t)
    neg_log_constants = -core.log_constants_p_x_given_z0(lig_size)
    kl_prior = core.kl_prior(xh0_lig, lm, lig_size)

    if training:
        log_p_x, log_p_h = core.log_pxh_given_z0_without_constants(
            xh0_lig[..., nd:], z_t_lig, eps_lig, net_lig, lm, gamma_t)
        loss_0_x = -log_p_x * t_is_zero
        loss_0_h = -log_p_h * t_is_zero
        error_t_lig = error_t_lig * (1.0 - t_is_zero)
    else:
        zeros = torch.zeros(b, device=dev)
        gamma_0 = core.schedule(zeros)
        z_0_lig, xh_pocket0, eps_0 = core.noised_representation(
            xh0_lig, xh0_pocket, lm, pm, gamma_0, noise0, generator)
        net_0, _ = eps_fn(z_0_lig, xh_pocket0, zeros, lm, pm)
        log_p_x, log_p_h = core.log_pxh_given_z0_without_constants(
            xh0_lig[..., nd:], z_0_lig, eps_0, net_0, lm, gamma_0)
        loss_0_x = -log_p_x
        loss_0_h = -log_p_h

    return {
        "delta_log_px": delta_log_px,
        "error_t_lig": error_t_lig,
        "snr_weight": snr_weight,
        "loss_0_x": loss_0_x,
        "loss_0_h": loss_0_h,
        "neg_log_constants": neg_log_constants,
        "kl_prior": kl_prior,
        "t_int": t_int,
        "xh_lig_hat": xh_lig_hat,
    }


def joint_loss_terms(core: JointDiffusion, eps_fn: EpsFn, ligand: NodeBatch,
                     pocket: NodeBatch, training: bool, t_int=None,
                     noise: Optional[JointDraw] = None,
                     noise0: Optional[JointDraw] = None, generator=None
                     ) -> Dict[str, torch.Tensor]:
    """The joint model's NLL terms of a batch: both parts noised in the
    joint zero-COM subspace of (N_lig + N_pocket - 1) * 3 dimensions, the
    pocket's error included, the joint KL prior.  t_int: [B] steps;
    noise / noise0: joint draws (``diffusion.joint.JointDraw``), the
    q(z_t | x) noise and (eval only) the noise of the t = 0 term."""
    b = ligand.x.shape[0]
    dev = ligand.x.device
    T = core.schedule.timesteps
    lm, pm = ligand.mask, pocket.mask
    nd = core.n_dims
    joint_size = ligand.size + pocket.size

    xh0_lig = core.normalize_xh(torch.cat([ligand.x, ligand.h], -1), lm)
    xh0_poc = core.normalize_xh(torch.cat([pocket.x, pocket.h], -1), pm)
    lx, px = remove_mean_joint(xh0_lig[..., :nd], xh0_poc[..., :nd], lm, pm)
    xh0_lig = torch.cat([lx, xh0_lig[..., nd:]], -1)
    xh0_poc = torch.cat([px, xh0_poc[..., nd:]], -1)

    subspace = (joint_size - 1) * 3.0
    delta_log_px = -subspace * math.log(core.cfg.norm_values[0])

    if t_int is None:
        t_int = draw_timesteps(b, T, training, generator, dev)
    t_int = torch.as_tensor(t_int, device=dev).float()
    t_is_zero = (t_int == 0).float()
    gamma_s = core.schedule((t_int - 1) / T)
    gamma_t = core.schedule(t_int / T)

    z_l, z_p, eps_l, eps_p = core.noised_representation(
        xh0_lig, xh0_poc, lm, pm, gamma_t, noise, generator)
    net_l, net_p = eps_fn(z_l, z_p, t_int / T, lm, pm)

    error_t_lig = sum_except_batch((eps_l - net_l) ** 2, lm)
    error_t_pocket = sum_except_batch((eps_p - net_p) ** 2, pm)
    snr_weight = 1.0 - S.snr(gamma_s - gamma_t)

    gamma_0s = core.schedule.table[0]
    neg_log_constants = -subspace * (-0.5 * gamma_0s
                                     - 0.5 * math.log(2 * math.pi))

    # the joint KL prior
    gamma_T = core.schedule(torch.ones(b, device=dev))
    alpha_T = _b11(S.alpha(gamma_T))
    sigma_T = S.sigma(gamma_T)
    mu_l, mu_p = alpha_T * xh0_lig, alpha_T * xh0_poc
    mu_h2 = (sum_except_batch(mu_l[..., nd:] ** 2, lm)
             + sum_except_batch(mu_p[..., nd:] ** 2, pm))
    mu_x2 = (sum_except_batch(mu_l[..., :nd] ** 2, lm)
             + sum_except_batch(mu_p[..., :nd] ** 2, pm))

    def gkl(mu2, q_sigma, d):
        return (d * torch.log(1.0 / q_sigma)
                + 0.5 * (d * q_sigma ** 2 + mu2) - 0.5 * d)

    kl_prior = gkl(mu_h2, sigma_T, 1.0) + gkl(mu_x2, sigma_T, subspace)

    if training:
        loss_0_x = -(-0.5 * sum_except_batch(
            (eps_l[..., :nd] - net_l[..., :nd]) ** 2, lm)) * t_is_zero
        loss_0_x_p = -(-0.5 * sum_except_batch(
            (eps_p[..., :nd] - net_p[..., :nd]) ** 2, pm)) * t_is_zero
        error_t_lig = error_t_lig * (1.0 - t_is_zero)
        error_t_pocket = error_t_pocket * (1.0 - t_is_zero)
    else:
        zeros = torch.zeros(b, device=dev)
        gamma_0 = core.schedule(zeros)
        z0_l, z0_p, e0_l, e0_p = core.noised_representation(
            xh0_lig, xh0_poc, lm, pm, gamma_0, noise0, generator)
        n0_l, n0_p = eps_fn(z0_l, z0_p, zeros, lm, pm)
        loss_0_x = 0.5 * sum_except_batch(
            (e0_l[..., :nd] - n0_l[..., :nd]) ** 2, lm)
        loss_0_x_p = 0.5 * sum_except_batch(
            (e0_p[..., :nd] - n0_p[..., :nd]) ** 2, pm)

    return {
        "delta_log_px": delta_log_px,
        "error_t_lig": error_t_lig,
        "error_t_pocket": error_t_pocket,
        "snr_weight": snr_weight,
        "loss_0_x": loss_0_x,
        "loss_0_x_pocket": loss_0_x_p,
        "loss_0_h": torch.zeros(b, device=dev),
        "neg_log_constants": neg_log_constants,
        "kl_prior": kl_prior,
        "t_int": t_int,
    }


def lj_potential(x, h_onehot, mask, lj_rm: torch.Tensor, norm_x: float,
                 clamp: float = 3.0) -> torch.Tensor:
    """Intra-ligand Lennard-Jones auxiliary potential, [B]."""
    pair = mask[:, :, None] * mask[:, None, :]
    pair = pair * (1.0 - torch.eye(x.shape[1], device=x.device))[None]
    d = torch.sqrt(((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
                   + 1e-12)
    types = h_onehot.argmax(-1)
    rm = lj_rm[types[:, :, None], types[:, None, :]] / 100.0 / norm_x
    sigma = 2.0 ** (-1.0 / 6.0) * rm
    # cap the ratio so ratio**12 stays finite in fp32: an inf forward value
    # poisons the backward pass even under the clamp below
    ratio = torch.clamp_max(sigma / torch.clamp_min(d, 1e-3), 100.0)
    out = torch.clamp_max(4.0 * (ratio ** 12 - ratio ** 6), clamp)
    return (out * pair).sum((1, 2))


def aux_weight_schedule(T: int, max_weight: float, mode: str = "linear",
                        device="cpu") -> torch.Tensor:
    """The auxiliary term's weight per step t = 0..T, [T + 1]."""
    if mode == "linear":
        return torch.linspace(max_weight, 0.0, T + 1, device=device)
    if mode == "constant":
        return torch.full((T + 1,), max_weight, device=device)
    raise NotImplementedError(mode)


def assemble_loss(terms: Dict, core: CondDiffusion, ligand: NodeBatch,
                  pocket: NodeBatch, cfg: TrainConfig, training: bool,
                  lj_rm: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """L2 (training) or VLB loss per sample; returns (nll [B], info)."""
    loss_type = core.cfg.loss_type
    lig_size = ligand.size
    info = {}
    if loss_type == "l2" and training:
        denom = 3.0 * lig_size + core.atom_nf * lig_size
        loss_t = 0.5 * terms["error_t_lig"] / denom
        loss_0 = terms["loss_0_x"] / (3.0 * lig_size) + terms["loss_0_h"]
        nll = loss_t + loss_0 + terms["kl_prior"]
    else:
        loss_t = (-core.schedule.timesteps * 0.5 * terms["snr_weight"]
                  * terms["error_t_lig"])
        loss_0 = (terms["loss_0_x"] + terms["loss_0_h"]
                  + terms["neg_log_constants"])
        nll = loss_t + loss_0 + terms["kl_prior"] - terms["delta_log_px"]

    if cfg.auxiliary_loss and loss_type == "l2" and training \
            and lj_rm is not None:
        sched = aux_weight_schedule(core.schedule.timesteps,
                                    cfg.aux_max_weight, cfg.aux_schedule,
                                    nll.device)
        w = sched[terms["t_int"].long()]
        xh_hat = terms["xh_lig_hat"]
        lj = lj_potential(xh_hat[..., :3], xh_hat[..., 3:], ligand.mask,
                          lj_rm, core.cfg.norm_values[0], cfg.aux_clamp_lj)
        nll = nll + w * lj
        info["weighted_lj"] = (w * lj).mean()

    info["error_t_lig"] = terms["error_t_lig"].mean()
    info["loss_0"] = loss_0.mean()
    info["kl_prior"] = terms["kl_prior"].mean()
    return nll, info
