"""Conditional variational-DDPM math over padded batches.

The JAX package's ``CondDiffusion``: sampling, and the likelihood terms
of the training loss (KL prior, the t = 0 reconstruction); with
``simple`` its ``pocket_conditioning_simple`` variant (no projection to
the ligand-COM-free subspace, the full-dimensional likelihood; the caller
subtracts the pocket's centre of mass).  Per-sample
gammas are [B] tensors broadcast as [B, 1, 1].  Every function that draws
noise takes it as an optional ``noise`` argument (the replay tests feed
the noise JAX drew); otherwise it draws from the given
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from diffndm_tpu_torch.config import DiffusionConfig
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.learned_gamma import LearnedGamma
from diffndm_tpu_torch.diffusion.schedules import GammaSchedule
from diffndm_tpu_torch.ops.segment import (masked_mean, remove_mean_ligand,
                                           sum_except_batch)

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


class DiffusionSettings:
    """Schedule and normalisation settings, shared by the conditional and
    the joint model."""

    def __init__(self, schedule: GammaSchedule, cfg: DiffusionConfig,
                 atom_nf: int, residue_nf: int, n_dims: int = 3):
        self.schedule = schedule
        self.cfg = cfg
        self.atom_nf = atom_nf
        self.residue_nf = residue_nf
        self.n_dims = n_dims

    @contextlib.contextmanager
    def run_schedule(self, timesteps: int):
        """Within, for a sampling run of ``timesteps`` reverse steps: a
        learned schedule's gamma on the run's grid k / timesteps, its
        network evaluated once (no gradient) and looked up by the steps
        (``GammaSchedule`` rounds t * timesteps: exact on the grid) instead
        of at every call; the same values, the reductions batched over
        other rows.  A predefined schedule stays as it is."""
        learned = self.schedule
        if not isinstance(learned, LearnedGamma):
            yield
            return
        with torch.no_grad():
            grid = learned(torch.arange(timesteps + 1) / timesteps)
        self.schedule = GammaSchedule(grid, timesteps, grid.device)
        try:
            yield
        finally:
            self.schedule = learned

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


class CondDiffusion(DiffusionSettings):
    """The conditional model's diffusion math."""

    def __init__(self, schedule, cfg: DiffusionConfig, atom_nf: int,
                 residue_nf: int, n_dims: int = 3, simple: bool = False):
        super().__init__(schedule, cfg, atom_nf, residue_nf, n_dims)
        self.simple = simple

    def _project(self, out_x, pocket_x, lig_mask, pocket_mask):
        """Re-centre both parts on the ligand's centre of mass; in the
        simple variant only mask them."""
        if self.simple:
            return (out_x * lig_mask[..., None],
                    pocket_x * pocket_mask[..., None])
        return remove_mean_ligand(out_x, pocket_x, lig_mask, pocket_mask)

    # -- schedule shortcut -----------------------------------------------------
    def gamma_int(self, step) -> torch.Tensor:
        """gamma at integer step indices (0..T), any shape."""
        return self.schedule.at_step(step)

    # -- q(z_t | x) -------------------------------------------------------------
    def noised_representation(self, xh_lig, xh_pocket, lig_mask,
                              pocket_mask, gamma_t, noise=None,
                              generator=None):
        """Noise the ligand at gamma_t [B], then re-centre both parts on
        the noisy ligand's centre of mass.  Returns (z_t_lig,
        xh_pocket_shifted, eps)."""
        a, s = _b11(S.alpha(gamma_t)), _b11(S.sigma(gamma_t))
        eps = draw_noise(xh_lig, noise, generator) * lig_mask[..., None]
        z_t = a * xh_lig + s * eps
        nd = self.n_dims
        zx, px = self._project(z_t[..., :nd], xh_pocket[..., :nd],
                               lig_mask, pocket_mask)
        z_t = torch.cat([zx, z_t[..., nd:]], -1)
        xh_pocket = torch.cat([px, xh_pocket[..., nd:]], -1)
        return z_t, xh_pocket, eps

    # -- z ~ N(mu, sigma) in the ligand-COM-free subspace --------------------
    def sample_normal_zero_com(self, mu_lig, xh_pocket, sigma, lig_mask,
                               pocket_mask, noise=None, generator=None):
        """sigma: [B].  Returns (z_lig, xh_pocket), both re-centred on the
        ligand centre of mass."""
        eps = draw_noise(mu_lig, noise, generator) * lig_mask[..., None]
        out = mu_lig + _b11(sigma) * eps
        nd = self.n_dims
        ox, px = self._project(out[..., :nd], xh_pocket[..., :nd],
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

    def sample_p_zt_given_zs(self, z_s_lig, xh_pocket, lig_mask, pocket_mask,
                             gamma_t, gamma_s, noise=None, generator=None):
        """The forward re-noising s -> t of RePaint's resampling:
        z_t ~ N(alpha_t|s z_s, sigma_t|s), re-centred.  gamma_t, gamma_s:
        [B]."""
        _, sig_ts, alpha_ts = S.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        return self.sample_normal_zero_com(_b11(alpha_ts) * z_s_lig,
                                           xh_pocket, sig_ts, lig_mask,
                                           pocket_mask, noise, generator)

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
        gamma_0 = self.gamma_int(torch.zeros(b, device=z0_lig.device))
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

    # -- loss terms -------------------------------------------------------------
    def subspace_dimensionality(self, num_nodes):
        """Degrees of freedom of the ligand coordinates: (N - 1) * 3 in the
        ligand-COM-free subspace, N * 3 in the simple variant."""
        if self.simple:
            return num_nodes * self.n_dims
        return (num_nodes - 1) * self.n_dims

    def kl_prior(self, xh_lig, lig_mask, num_nodes):
        """KL(q(z_T | x) || N(0, 1)) of the ligand, [B]."""
        b = xh_lig.shape[0]
        gamma_T = self.gamma_int(torch.full((b,), self.schedule.timesteps,
                                            device=xh_lig.device))
        mu = _b11(S.alpha(gamma_T)) * xh_lig
        mu_x, mu_h = mu[..., :self.n_dims], mu[..., self.n_dims:]
        sigma_T = S.sigma(gamma_T)

        def gaussian_kl(mu_norm2, q_sigma, d):
            return (d * torch.log(1.0 / q_sigma)
                    + 0.5 * (d * q_sigma ** 2 + mu_norm2) - 0.5 * d)

        kl_h = gaussian_kl(sum_except_batch(mu_h ** 2, lig_mask), sigma_T,
                           1.0)
        kl_x = gaussian_kl(sum_except_batch(mu_x ** 2, lig_mask), sigma_T,
                           self.subspace_dimensionality(num_nodes))
        return kl_x + kl_h

    def log_constants_p_x_given_z0(self, num_nodes):
        """The normalising constants of p(x | z0), [B]."""
        gamma_0 = self.gamma_int(0)
        dof = self.subspace_dimensionality(num_nodes)
        return dof * (-0.5 * gamma_0 - 0.5 * math.log(2 * math.pi))

    def log_pxh_given_z0_without_constants(self, lig_h_onehot, z0_lig,
                                           eps_lig, net_lig, lig_mask,
                                           gamma_0, epsilon=1e-10):
        """The t = 0 reconstruction terms (log_p_x, log_p_h), each [B].
        lig_h_onehot: the clean ligand's normalised one-hot features;
        gamma_0: [B]."""
        nh = self.cfg.norm_values[1]
        bh = self.cfg.norm_biases[1]
        nd = self.n_dims
        sq = (eps_lig[..., :nd] - net_lig[..., :nd]) ** 2
        vidx = self.cfg.virtual_node_idx
        if vidx is not None:
            sq = sq * (1.0 - lig_h_onehot[..., vidx:vidx + 1])
        log_p_x = -0.5 * sum_except_batch(sq, lig_mask)

        sigma_0_cat = _b11(S.sigma(gamma_0)) * nh
        onehot = lig_h_onehot * nh + bh
        centered = z0_lig[..., nd:] * nh + bh - 1.0

        def cdf(v):
            return 0.5 * (1.0 + torch.erf(v / math.sqrt(2)))

        # fp32 rounding can make the difference slightly negative when both
        # tails saturate; clamp before the log
        cdf_diff = (cdf((centered + 0.5) / sigma_0_cat)
                    - cdf((centered - 0.5) / sigma_0_cat))
        log_ph = torch.log(cdf_diff.clamp_min(0.0) + epsilon)
        log_probs = log_ph - torch.logsumexp(log_ph, dim=-1, keepdim=True)
        log_p_h = sum_except_batch(log_probs * onehot, lig_mask)
        return log_p_x, log_p_h


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
