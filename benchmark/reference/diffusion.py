"""Plain reference of DiffSBDD's conditional sampler (arXiv:2210.13695,
``equivariant_diffusion/conditional_model.py``): the polynomial noise
schedule, the start from the pocket's centre, one reverse step t -> s and
the final decode, over padded batches in float32.

It imports nothing of the program.  Each function takes the noise it
injects, as the benchmark hands the same noise to the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gamma_table(schedule: str, timesteps: int, precision: float
                ) -> np.ndarray:
    """gamma = -log(alpha^2 / sigma^2) on the grid 0..T of
    ``polynomial_<power>``: alpha^2 = (1 - (t / T')^power)^2 over T' = T+1
    points, the per-step ratio clipped at 0.001, scaled to [s, 1 - s]
    with s = precision; computed in float64, kept in float32."""
    if not schedule.startswith("polynomial_"):
        raise ValueError(f"no reference for the schedule {schedule!r}")
    power = float(schedule.split("_")[1])
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    a2 = (1 - np.power(x / steps, power)) ** 2
    a2 = np.concatenate([np.ones(1), a2])
    a2 = np.cumprod(np.clip(a2[1:] / a2[:-1], 0.001, 1.0))
    a2 = (1 - 2 * precision) * a2 + precision
    return (-(np.log(a2) - np.log(1.0 - a2))).astype(np.float32)


def _b(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1)


def ligand_com_free(x_lig, x_pocket, lig_mask, pocket_mask):
    """Both parts shifted by the ligand's centre of mass."""
    ml = lig_mask[..., None]
    mean = (x_lig * ml).sum(1, keepdim=True) / ml.sum(1, keepdim=True
                                                      ).clamp_min(1e-12)
    return (x_lig - mean) * ml, (x_pocket - mean) * pocket_mask[..., None]


def _normal_com_free(mu, xh_pocket, sigma, noise, lig_mask, pocket_mask):
    out = mu + _b(sigma) * noise * lig_mask[..., None]
    x, px = ligand_com_free(out[..., :3], xh_pocket[..., :3], lig_mask,
                            pocket_mask)
    return (torch.cat([x, out[..., 3:]], -1),
            torch.cat([px, xh_pocket[..., 3:]], -1))


def start(pocket_x, pocket_h, lig_mask, pocket_mask, noise, norm_values,
          atom_nf):
    """z_T ~ N(pocket centre, 1) for the ligand, and the pocket, both in
    the ligand's centre-of-mass frame.  pocket_x / pocket_h as the
    dataset gives them; returns (z_lig, xh_pocket), normalised."""
    nx, nh = norm_values
    pm = pocket_mask[..., None]
    px, ph = pocket_x / nx * pm, pocket_h / nh * pm
    b, nl = lig_mask.shape
    mu_x = (px * pm).sum(1, keepdim=True) / pm.sum(1, keepdim=True
                                                   ).clamp_min(1e-12)
    mu = torch.cat([mu_x.expand(b, nl, 3), px.new_zeros(b, nl, atom_nf)], -1)
    mu = mu * lig_mask[..., None]
    return _normal_com_free(mu, torch.cat([px, ph], -1),
                            torch.ones(b, device=px.device), noise, lig_mask,
                            pocket_mask)


def _softplus(v):
    return F.softplus(v, beta=1.0, threshold=1e30)


def step(gamma: torch.Tensor, s: int, z_lig, xh_pocket, eps, noise,
         lig_mask, pocket_mask):
    """One reverse step from t = s + 1 to s, given the denoiser's eps at
    t: z_s = z_t / alpha_t|s - sigma2_t|s / alpha_t|s / sigma_t eps +
    sigma_t|s sigma_s / sigma_t noise, projected."""
    b = z_lig.shape[0]
    gs = gamma[s].expand(b)
    gt = gamma[s + 1].expand(b)
    sig2_ts = -torch.expm1(_softplus(gs) - _softplus(gt))
    alpha_ts = torch.exp(0.5 * (F.logsigmoid(-gt) - F.logsigmoid(-gs)))
    sigma_s = torch.sqrt(torch.sigmoid(gs))
    sigma_t = torch.sqrt(torch.sigmoid(gt))
    mu = z_lig / _b(alpha_ts) - _b(sig2_ts / alpha_ts / sigma_t) * eps
    sigma = torch.sqrt(sig2_ts) * sigma_s / sigma_t
    return _normal_com_free(mu, xh_pocket, sigma, noise, lig_mask,
                            pocket_mask)


def decode(gamma: torch.Tensor, z0, xh_pocket, eps, noise, lig_mask,
           pocket_mask, pocket_x_in, pocket_mask_in, norm_values, atom_nf):
    """x, h ~ p(x, h | z0), then the shift back into the frame of the
    pocket as given.  Returns (x_lig [B, NL, 3], one-hot types [B, NL,
    atom_nf])."""
    b = z0.shape[0]
    g0 = gamma[0].expand(b)
    alpha0 = torch.sqrt(torch.sigmoid(-g0))
    sigma0 = torch.sqrt(torch.sigmoid(g0))
    mu = z0 / _b(alpha0) - eps * _b(sigma0 / alpha0)
    xh, xh_p = _normal_com_free(mu, xh_pocket, torch.exp(0.5 * g0), noise,
                                lig_mask, pocket_mask)
    nx, nh = norm_values
    x_lig = xh[..., :3] * nx
    x_poc = xh_p[..., :3] * nx
    types = (z0[..., 3:] * nh).argmax(-1)
    onehot = F.one_hot(types, atom_nf).to(x_lig.dtype)
    pmi = pocket_mask_in[..., None]
    before = (pocket_x_in * pmi).sum(1, keepdim=True) / pmi.sum(
        1, keepdim=True).clamp_min(1e-12)
    pm = pocket_mask[..., None]
    after = (x_poc * pm).sum(1, keepdim=True) / pm.sum(
        1, keepdim=True).clamp_min(1e-12)
    ml = lig_mask[..., None]
    return (x_lig + before - after) * ml, onehot * ml
