"""Noise schedules and the alpha/sigma algebra of the variational DDPM.

gamma = log(sigma^2 / alpha^2).  A predefined schedule is a float64 numpy
table of length T+1, stored as float32; gamma(t) indexes it by
round(t * T), so a trajectory with fewer steps than T reads the T-step
table.  The learned schedule (``learned``) is a network
(``learned_gamma.LearnedGamma``) with the same interface.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from diffndm_tpu_torch.diffusion.learned_gamma import (GammaNetwork,
                                                       LearnedGamma)


def clip_noise_schedule(alphas2: np.ndarray, clip_value: float = 0.001
                        ) -> np.ndarray:
    """Clip the per-step alpha ratio for sampling stability."""
    alphas2 = np.concatenate([np.ones(1), alphas2], axis=0)
    steps = np.clip(alphas2[1:] / alphas2[:-1], a_min=clip_value, a_max=1.0)
    return np.cumprod(steps, axis=0)


def polynomial_alphas2(timesteps: int, s: float = 1e-4, power: float = 3.0
                       ) -> np.ndarray:
    """alpha_t^2 = (1 - (t/T)^power)^2, clipped and precision-scaled."""
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas2 = (1 - np.power(x / steps, power)) ** 2
    alphas2 = clip_noise_schedule(alphas2, clip_value=0.001)
    precision = 1 - 2 * s
    return precision * alphas2 + s


def cosine_alphas2(timesteps: int, s: float = 0.008,
                   raise_to_power: float = 1.0) -> np.ndarray:
    """Nichol & Dhariwal cosine schedule."""
    steps = timesteps + 2
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = np.clip(1 - (alphas_cumprod[1:] / alphas_cumprod[:-1]), 0, 0.999)
    out = np.cumprod(1.0 - betas, axis=0)
    if raise_to_power != 1:
        out = np.power(out, raise_to_power)
    return out


def gamma_table(name: str, timesteps: int, precision: float = 1e-4
                ) -> np.ndarray:
    """The float32 gamma table [T+1] of a named schedule."""
    if name == "cosine":
        alphas2 = cosine_alphas2(timesteps)
    elif "polynomial" in name:
        power = float(name.split("_")[1])
        alphas2 = polynomial_alphas2(timesteps, s=precision, power=power)
    elif name == "learned":
        raise ValueError("the learned schedule has no fixed table: "
                         "make_schedule builds its network")
    else:
        raise ValueError(f"unknown noise schedule {name!r}")
    sigmas2 = 1.0 - alphas2
    gamma = -(np.log(alphas2) - np.log(sigmas2))
    return gamma.astype(np.float32)


class GammaSchedule:
    """gamma lookup table of length T+1 on a device."""

    def __init__(self, table: np.ndarray, timesteps: int, device="cpu"):
        self.table = torch.as_tensor(table, dtype=torch.float32,
                                     device=device)
        self.timesteps = timesteps

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """gamma at normalised time t in [0, 1]; any shape."""
        idx = torch.round(t * self.timesteps).long()
        return self.table[idx.clamp(0, self.timesteps)]

    def at_step(self, step: torch.Tensor) -> torch.Tensor:
        """gamma at integer step index (0..T)."""
        return self.table[torch.as_tensor(step, device=self.table.device)
                          .long().clamp(0, self.timesteps)]


def make_schedule(name: str, timesteps: int, precision: float = 1e-4,
                  device="cpu"):
    """The named schedule on ``device``: a ``GammaSchedule``, or for
    ``learned`` a ``LearnedGamma`` over a freshly initialised network."""
    if name == "learned":
        return LearnedGamma(GammaNetwork().to(device), timesteps)
    return GammaSchedule(gamma_table(name, timesteps, precision), timesteps,
                         device)


def alpha(gamma: torch.Tensor) -> torch.Tensor:
    """alpha = sqrt(sigmoid(-gamma))."""
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma(gamma: torch.Tensor) -> torch.Tensor:
    """sigma = sqrt(sigmoid(gamma))."""
    return torch.sqrt(torch.sigmoid(gamma))


def snr(gamma: torch.Tensor) -> torch.Tensor:
    """alpha^2 / sigma^2 = exp(-gamma)."""
    return torch.exp(-gamma)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    # log(1 + exp(v)) without torch's linear cut-over above 20
    return F.softplus(v, beta=1.0, threshold=1e30)


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """Transition coefficients between two noise levels.
    Returns (sigma2_t|s, sigma_t|s, alpha_t|s)."""
    sigma2_t_given_s = -torch.expm1(_softplus(gamma_s) - _softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    return sigma2_t_given_s, torch.sqrt(sigma2_t_given_s), alpha_t_given_s


def check_norm_values(schedule: GammaSchedule, norm_value: float,
                      num_stdevs: int = 8) -> None:
    """Check that sigma_0 is small against the categorical normalisation."""
    sigma_0 = float(sigma(schedule.table[0]))
    if sigma_0 * num_stdevs > 1.0 / norm_value:
        raise ValueError(
            f"normalization value {norm_value} too large for sigma_0="
            f"{sigma_0:.5f} (1/norm_value={1.0 / norm_value})")
