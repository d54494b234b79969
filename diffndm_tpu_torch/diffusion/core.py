"""Conditional variational-DDPM sampling math over padded batches.

The sampling half of the JAX package's ``CondDiffusion``.  Per-sample
gammas are [B] tensors broadcast as [B, 1, 1].  Every function that draws
noise takes it as an optional ``noise`` argument (the replay tests feed
the noise JAX drew); otherwise it draws from the given
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from diffndm_tpu_torch.config import DiffusionConfig
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.schedules import GammaSchedule
from diffndm_tpu_torch.ops.segment import masked_mean, remove_mean_ligand

# eps_fn(xh_lig, xh_pocket, t, lig_mask, pocket_mask) -> (eps_lig, eps_pocket)
EpsFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _b11(v: torch.Tensor) -> torch.Tensor:
    """[B] -> [B, 1, 1]."""
    return v.reshape(-1, 1, 1)


def draw_noise(like: torch.Tensor, noise: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The given noise (moved to like's device), or a standard normal draw
    of like's shape from ``generator``."""
    if noise is not None:
        if noise.shape != like.shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, "
                             f"expected {tuple(like.shape)}")
        return noise.to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=like.dtype)


class CondDiffusion:
    """Schedule + normalisation settings of the conditional model."""

    def __init__(self, schedule: GammaSchedule, cfg: DiffusionConfig,
                 atom_nf: int, residue_nf: int, n_dims: int = 3):
        self.schedule = schedule
        self.cfg = cfg
        self.atom_nf = atom_nf
        self.residue_nf = residue_nf
        self.n_dims = n_dims

    # -- normalisation ------------------------------------------------------
    def normalize_xh(self, xh: torch.Tensor, mask: torch.Tensor):
        nx, nh = self.cfg.norm_values
        bh = self.cfg.norm_biases[1]
        x = xh[..., :self.n_dims] / nx
        h = (xh[..., self.n_dims:] - bh) / nh
        return torch.cat([x, h], -1) * mask[..., None]

    def unnormalize_xh(self, xh: torch.Tensor, mask: torch.Tensor):
        nx, nh = self.cfg.norm_values
        bh = self.cfg.norm_biases[1]
        x = xh[..., :self.n_dims] * nx
        h = xh[..., self.n_dims:] * nh + bh
        return torch.cat([x, h], -1) * mask[..., None]

    # -- z ~ N(mu, sigma) in the ligand-COM-free subspace --------------------
    def sample_normal_zero_com(self, mu_lig, xh_pocket, sigma, lig_mask,
                               pocket_mask, noise=None, generator=None):
        """sigma: [B].  Returns (z_lig, xh_pocket), both re-centred on the
        ligand centre of mass."""
        eps = draw_noise(mu_lig, noise, generator) * lig_mask[..., None]
        out = mu_lig + _b11(sigma) * eps
        nd = self.n_dims
        ox, px = remove_mean_ligand(out[..., :nd], xh_pocket[..., :nd],
                                    lig_mask, pocket_mask)
        out = torch.cat([ox, out[..., nd:]], -1)
        xh_pocket = torch.cat([px, xh_pocket[..., nd:]], -1)
        return out, xh_pocket

    # -- one reverse step t -> s ----------------------------------------------
    def sample_p_zs_given_zt(self, s_norm, t_norm, z_lig, xh_pocket,
                             lig_mask, pocket_mask, eps_fn: EpsFn,
                             adjust_fn=None, noise=None, generator=None,
                             noise_scale: float = 1.0):
        """s_norm, t_norm: normalised times [B]; the gamma lookup rounds
        t*T.  noise_scale scales the injected noise only (the posterior
        mean stays exact).

        adjust_fn: an optional policy z_t -> adjustment, added to the
        denoiser's eps (the AdjustNet); its log-prob proxy is
        -0.5 * mean((adjustment - eps)^2) over the whole padded batch.

        Returns (z_s, xh_pocket, log_prob, eps): log_prob is a 0-d tensor
        (the float 0.0 without adjust_fn, which costs the step no device
        work) and eps the denoiser's, before adjustment."""
        gamma_s = self.schedule(s_norm)
        gamma_t = self.schedule(t_norm)
        sig2_ts, sig_ts, alpha_ts = S.sigma_and_alpha_t_given_s(
            gamma_t, gamma_s)
        sigma_s, sigma_t = S.sigma(gamma_s), S.sigma(gamma_t)

        eps_pre, _ = eps_fn(z_lig, xh_pocket, t_norm, lig_mask, pocket_mask)
        eps_lig, log_prob = eps_pre, 0.0
        if adjust_fn is not None:
            adjustment = adjust_fn(z_lig)
            log_prob = -0.5 * ((adjustment - eps_pre) ** 2).mean()
            eps_lig = eps_pre + adjustment
        mu = (z_lig / _b11(alpha_ts)
              - _b11(sig2_ts / alpha_ts / sigma_t) * eps_lig)
        sigma = sig_ts * sigma_s / sigma_t
        if noise_scale != 1.0:
            sigma = sigma * noise_scale
        z_s, xh_pocket = self.sample_normal_zero_com(
            mu, xh_pocket, sigma, lig_mask, pocket_mask, noise, generator)
        return z_s, xh_pocket, log_prob, eps_pre

    # -- x0 prediction ----------------------------------------------------------
    def xh_given_zt_and_epsilon(self, z_t, eps, gamma_t):
        a, s = _b11(S.alpha(gamma_t)), _b11(S.sigma(gamma_t))
        return z_t / a - eps * s / a

    def to_x0(self, z_t_lig, xh_pocket, t_norm, lig_mask, pocket_mask,
              eps_fn: EpsFn):
        """Predict eps at t and roll to z0 in one step (the guidance
        lookahead).  t_norm: a scalar or [B]."""
        t_norm = torch.as_tensor(t_norm, dtype=z_t_lig.dtype,
                                 device=z_t_lig.device).expand(
            z_t_lig.shape[0])
        gamma_t = self.schedule(t_norm)
        eps_lig, _ = eps_fn(z_t_lig, xh_pocket, t_norm, lig_mask,
                            pocket_mask)
        return self.xh_given_zt_and_epsilon(z_t_lig, eps_lig, gamma_t)

    def sample_p_xh_given_z0(self, z0_lig, xh_pocket, lig_mask, pocket_mask,
                             eps_fn: EpsFn, noise=None, generator=None):
        """Final decode x, h ~ p(x, h | z0).  Returns (x_lig, h_lig_onehot,
        x_pocket, h_pocket), unnormalised; ligand types are the one-hot
        argmax of the types decoded from z0."""
        b = z0_lig.shape[0]
        gamma_0 = self.schedule.table[0].expand(b)
        sigma_x = S.snr(-0.5 * gamma_0)
        t_zeros = torch.zeros(b, device=z0_lig.device)
        eps_lig, _ = eps_fn(z0_lig, xh_pocket, t_zeros, lig_mask,
                            pocket_mask)
        mu_x = self.xh_given_zt_and_epsilon(z0_lig, eps_lig, gamma_0)
        xh_lig, xh_pocket = self.sample_normal_zero_com(
            mu_x, xh_pocket, sigma_x, lig_mask, pocket_mask, noise,
            generator)

        nx, nh = self.cfg.norm_values
        bh = self.cfg.norm_biases[1]
        nd = self.n_dims
        x_lig = xh_lig[..., :nd] * nx
        h_lig = z0_lig[..., nd:] * nh + bh
        x_pocket = xh_pocket[..., :nd] * nx
        h_pocket = xh_pocket[..., nd:] * nh + bh
        h_onehot = F.one_hot(h_lig.argmax(-1), self.atom_nf).to(x_lig.dtype)
        ml = lig_mask[..., None]
        mp = pocket_mask[..., None]
        return x_lig * ml, h_onehot * ml, x_pocket * mp, h_pocket * mp


def init_ligand_from_pocket(core: CondDiffusion, pocket_x, pocket_h,
                            lig_mask, pocket_mask, noise=None,
                            generator=None):
    """Initial z_lig ~ N(pocket COM, 1), projected to zero ligand COM.
    The pocket must already be normalised."""
    b, nl = lig_mask.shape
    mu_x = masked_mean(pocket_x, pocket_mask, dim=1, keepdim=True)
    mu = torch.cat([mu_x.expand(b, nl, core.n_dims),
                    pocket_x.new_zeros(b, nl, core.atom_nf)], -1)
    mu = mu * lig_mask[..., None]
    xh0_pocket = torch.cat([pocket_x, pocket_h], -1)
    return core.sample_normal_zero_com(
        mu, xh0_pocket, torch.ones(b, device=mu.device), lig_mask,
        pocket_mask, noise, generator)
