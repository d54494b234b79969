"""Joint E(n) variational diffusion over ligand and pocket.

The JAX package's ``diffusion/joint.py`` (mode 'joint'): both the ligand
and the pocket are denoised, the zero centre-of-mass subspace is that of
the joint point cloud, and the size prior draws (N_lig, N_pocket) jointly.
``JointSampler.sample`` generates both parts; ``JointSampler.inpaint``
completes the unfixed nodes of a ligand-pocket pair by RePaint with
resamplings and jumps of ``jump_length`` steps.

Torch cannot replay JAX's threefry streams, so every function that draws
noise takes it as an argument: one joint draw is a pair of raw standard
normals (ligand [B, NL, 3 + atom_nf], pocket [B, NP, 3 + residue_nf]),
masked and projected here; what is not given is drawn from ``generator``.
Each reverse step is a ``sampler.step`` span and the decode a ``decode``
span (``utils.profiling``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.core import (DiffusionSettings, EpsFn, _b11,
                                              draw_noise)
from diffndm_tpu_torch.ops.segment import remove_mean_joint
from diffndm_tpu_torch.structs import NodeBatch, pad_to
from diffndm_tpu_torch.utils.profiling import annotate

# one joint draw: raw N(0, 1) for the ligand and the pocket, full width
JointDraw = Tuple[torch.Tensor, torch.Tensor]


def _with_x(z: torch.Tensor, x: torch.Tensor, nd: int) -> torch.Tensor:
    return torch.cat([x, z[..., nd:]], -1)


class JointDiffusion(DiffusionSettings):
    """The joint model's diffusion math."""

    # -- joint noise ----------------------------------------------------------
    def sample_joint_noise(self, lig_mask, pocket_mask,
                           noise: Optional[JointDraw] = None,
                           generator: Optional[torch.Generator] = None):
        """Positional noise centred on the joint centre of mass and
        standard feature noise, masked.  Returns (eps_lig, eps_pocket)."""
        b, nl = lig_mask.shape
        npk = pocket_mask.shape[1]
        nd = self.n_dims
        like_l = lig_mask.new_empty(b, nl, nd + self.atom_nf)
        like_p = pocket_mask.new_empty(b, npk, nd + self.residue_nf)
        n_l, n_p = (None, None) if noise is None else noise
        e_l = draw_noise(like_l, n_l, generator) * lig_mask[..., None]
        e_p = draw_noise(like_p, n_p, generator) * pocket_mask[..., None]
        return self._project(e_l, e_p, lig_mask, pocket_mask)

    def _project(self, z_l, z_p, lig_mask, pocket_mask):
        """Both parts' coordinates moved to zero joint centre of mass."""
        nd = self.n_dims
        x_l, x_p = remove_mean_joint(z_l[..., :nd], z_p[..., :nd], lig_mask,
                                     pocket_mask)
        return _with_x(z_l, x_l, nd), _with_x(z_p, x_p, nd)

    def noised_representation(self, xh_lig, xh_pocket, lig_mask,
                              pocket_mask, gamma_t, noise=None,
                              generator=None):
        """q(z_t | x) of both parts at gamma_t [B].  Returns (z_lig,
        z_pocket, eps_lig, eps_pocket)."""
        a, s = _b11(S.alpha(gamma_t)), _b11(S.sigma(gamma_t))
        eps_l, eps_p = self.sample_joint_noise(lig_mask, pocket_mask, noise,
                                               generator)
        return a * xh_lig + s * eps_l, a * xh_pocket + s * eps_p, eps_l, eps_p

    # -- one reverse step t -> s ----------------------------------------------
    def sample_p_zs_given_zt(self, s_norm, t_norm, z_lig, z_pocket,
                             lig_mask, pocket_mask, eps_fn: EpsFn,
                             fix_noise: bool = False, noise=None,
                             generator=None):
        """s_norm, t_norm: normalised times [B].  fix_noise: the posterior
        mean, no noise.  Returns (z_lig, z_pocket) at s, projected to the
        joint zero-COM subspace."""
        gamma_s, gamma_t = self.schedule(s_norm), self.schedule(t_norm)
        sig2_ts, sig_ts, alpha_ts = S.sigma_and_alpha_t_given_s(gamma_t,
                                                                gamma_s)
        sigma_s, sigma_t = S.sigma(gamma_s), S.sigma(gamma_t)
        eps_l, eps_p = eps_fn(z_lig, z_pocket, t_norm, lig_mask, pocket_mask)
        coef = _b11(sig2_ts / alpha_ts / sigma_t)
        mu_l = z_lig / _b11(alpha_ts) - coef * eps_l
        mu_p = z_pocket / _b11(alpha_ts) - coef * eps_p
        sigma = _b11(sig_ts * sigma_s / sigma_t)
        if fix_noise:
            z_l, z_p = mu_l, mu_p
        else:
            n_l, n_p = self.sample_joint_noise(lig_mask, pocket_mask, noise,
                                               generator)
            z_l, z_p = mu_l + sigma * n_l, mu_p + sigma * n_p
        return self._project(z_l, z_p, lig_mask, pocket_mask)

    def sample_p_zt_given_zs(self, z_lig, z_pocket, lig_mask, pocket_mask,
                             gamma_t, gamma_s, noise=None, generator=None):
        """RePaint's forward re-noising s -> t, gamma_t and gamma_s [B]."""
        _, sig_ts, alpha_ts = S.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        n_l, n_p = self.sample_joint_noise(lig_mask, pocket_mask, noise,
                                           generator)
        z_l = _b11(alpha_ts) * z_lig + _b11(sig_ts) * n_l
        z_p = _b11(alpha_ts) * z_pocket + _b11(sig_ts) * n_p
        return self._project(z_l, z_p, lig_mask, pocket_mask)

    def sample_p_xh_given_z0(self, z0_lig, z0_pocket, lig_mask, pocket_mask,
                             eps_fn: EpsFn, fix_noise: bool = False,
                             noise=None, generator=None):
        """The final decode of both parts.  Returns (x_lig, h_lig, x_pocket,
        h_pocket), unnormalised; types are the one-hot argmax of the types
        decoded from z0."""
        b = z0_lig.shape[0]
        zeros = torch.zeros(b, device=z0_lig.device)
        gamma_0 = self.schedule(zeros)
        sigma_x = _b11(S.snr(-0.5 * gamma_0))
        eps_l, eps_p = eps_fn(z0_lig, z0_pocket, zeros, lig_mask,
                              pocket_mask)
        a0, s0 = _b11(S.alpha(gamma_0)), _b11(S.sigma(gamma_0))
        mu_l = z0_lig / a0 - eps_l * s0 / a0
        mu_p = z0_pocket / a0 - eps_p * s0 / a0
        if fix_noise:
            xh_l, xh_p = mu_l, mu_p
        else:
            n_l, n_p = self.sample_joint_noise(lig_mask, pocket_mask, noise,
                                               generator)
            xh_l, xh_p = mu_l + sigma_x * n_l, mu_p + sigma_x * n_p

        nx, nh = self.cfg.norm_values
        bh = self.cfg.norm_biases[1]
        nd = self.n_dims
        x_l, x_p = xh_l[..., :nd] * nx, xh_p[..., :nd] * nx
        h_l = z0_lig[..., nd:] * nh + bh
        h_p = z0_pocket[..., nd:] * nh + bh
        h_l = F.one_hot(h_l.argmax(-1), self.atom_nf).to(x_l.dtype)
        h_p = F.one_hot(h_p.argmax(-1), self.residue_nf).to(x_p.dtype)
        ml, mp = lig_mask[..., None], pocket_mask[..., None]
        return x_l * ml, h_l * ml, x_p * mp, h_p * mp


def get_repaint_schedule(resamplings: int, jump_length: int,
                         timesteps: int) -> List[int]:
    """The lengths of the denoising runs between jumps, in run order."""
    schedule: List[int] = []
    curr_t = 0
    while curr_t < timesteps:
        if curr_t + jump_length < timesteps:
            if schedule:
                schedule[-1] += jump_length
                schedule.extend([jump_length] * (resamplings - 1))
            else:
                schedule.extend([jump_length] * resamplings)
            curr_t += jump_length
        else:
            residual = timesteps - curr_t
            if schedule:
                schedule[-1] += residual
            else:
                schedule.append(residual)
            curr_t += residual
    return list(reversed(schedule))


def count_joint_forwards(timesteps: int, resamplings: int = 1,
                         jump_length: int = 1) -> int:
    """Denoiser forwards of one ``JointSampler.inpaint`` call: one per
    denoising step of the RePaint schedule and the decode.  With the
    defaults, those of ``JointSampler.sample`` (T + 1)."""
    return sum(get_repaint_schedule(resamplings, jump_length,
                                    timesteps)) + 1


def count_joint_draws(timesteps: int, resamplings: int = 1,
                      jump_length: int = 1, inpaint: bool = False) -> int:
    """Joint draws one call consumes, in the order the ``noise`` sequence
    gives them.  ``sample``: the initial z, one per step, the decode.
    ``inpaint``: the initial z; per denoising step the step's and then the
    known part's; per jump one; the decode."""
    if not inpaint:
        return timesteps + 2
    schedule = get_repaint_schedule(resamplings, jump_length, timesteps)
    return 2 + 2 * sum(schedule) + len(schedule) - 1


class _Draws:
    """The fixed joint draws of a call, handed out in order (None where
    the generator draws)."""

    def __init__(self, noise: Optional[Sequence[JointDraw]], expected: int):
        if noise is not None and len(noise) != expected:
            raise ValueError(f"noise holds {len(noise)} joint draws, the "
                             f"call consumes {expected}")
        self._it: Optional[Iterator] = None if noise is None else iter(noise)

    def next(self) -> Optional[JointDraw]:
        return None if self._it is None else next(self._it)


class JointSampler:
    """``sample`` and ``inpaint`` for the joint model."""

    def __init__(self, core: JointDiffusion, dynamics: torch.nn.Module):
        self.core = core
        self.dynamics = dynamics

    def _eps(self, z_l, z_p, t, lig_mask, pocket_mask):
        return self.dynamics(z_l, z_p, t, lig_mask, pocket_mask)

    @staticmethod
    def _masks(num_nodes_lig, num_nodes_pocket, lig_pad, pocket_pad,
               device):
        out = []
        for sizes, pad in ((num_nodes_lig, lig_pad),
                           (num_nodes_pocket, pocket_pad)):
            sizes = np.asarray(sizes)
            n = pad_to(int(sizes.max()), pad)
            out.append(torch.from_numpy((np.arange(n)[None] < sizes[:, None])
                                        .astype(np.float32)).to(device))
        return out

    @torch.no_grad()
    def sample(self, num_nodes_lig, num_nodes_pocket,
               timesteps: Optional[int] = None, lig_pad: int = 8,
               pocket_pad: int = 32,
               noise: Optional[Sequence[JointDraw]] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[NodeBatch, NodeBatch]:
        """Generate ligand and pocket of the given sizes [B] each: T
        reverse steps from joint noise, the decode, and the final joint
        centre-of-mass projection, on the denoiser's device.  noise: ``count_joint_draws(T)`` joint draws (the initial z,
        step T-1 .. 0, the decode); else drawn from ``generator``."""
        core = self.core
        timesteps = timesteps or core.schedule.timesteps
        device = next(self.dynamics.parameters()).device
        lm, pm = self._masks(num_nodes_lig, num_nodes_pocket, lig_pad,
                             pocket_pad, device)
        draws = _Draws(noise, count_joint_draws(timesteps))
        b = lm.shape[0]
        z_l, z_p = core.sample_joint_noise(lm, pm, draws.next(), generator)
        for s in range(timesteps - 1, -1, -1):
            with annotate("sampler.step"):
                s_norm = torch.full((b,), float(s), device=device) / timesteps
                t_norm = torch.full((b,), float(s + 1),
                                    device=device) / timesteps
                z_l, z_p = core.sample_p_zs_given_zt(
                    s_norm, t_norm, z_l, z_p, lm, pm, self._eps,
                    noise=draws.next(), generator=generator)
        with annotate("decode"):
            x_l, h_l, x_p, h_p = core.sample_p_xh_given_z0(
                z_l, z_p, lm, pm, self._eps, noise=draws.next(),
                generator=generator)
            # centre-of-gravity drift projection
            x_l, x_p = remove_mean_joint(x_l, x_p, lm, pm)
        return NodeBatch(x_l, h_l, lm), NodeBatch(x_p, h_p, pm)

    @torch.no_grad()
    def inpaint(self, ligand: NodeBatch, pocket: NodeBatch, lig_fixed,
                pocket_fixed, resamplings: int = 1, jump_length: int = 1,
                timesteps: Optional[int] = None,
                noise: Optional[Sequence[JointDraw]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[NodeBatch, NodeBatch]:
        """Joint RePaint: the nodes where ``lig_fixed`` [B, NL] /
        ``pocket_fixed`` [B, NP] are 1 follow the noised input, the others
        are generated.  The denoising runs of ``get_repaint_schedule``
        alternate with jumps that re-noise ``jump_length`` steps up.  The
        input is centred on the centre of mass of its fixed nodes, and the
        known part, once noised, is moved onto the generated part's
        fixed-node centre of mass at every step.  noise:
        ``count_joint_draws(T, resamplings, jump_length, inpaint=True)``
        joint draws in the order they are consumed; else drawn from
        ``generator``."""
        core = self.core
        timesteps = timesteps or core.schedule.timesteps
        nd = core.n_dims
        lm, pm = ligand.mask, pocket.mask
        b = lm.shape[0]
        device = lm.device
        lf = torch.as_tensor(lig_fixed, dtype=torch.float32,
                             device=device)[..., None]
        pf = torch.as_tensor(pocket_fixed, dtype=torch.float32,
                             device=device)[..., None]
        draws = _Draws(noise, count_joint_draws(timesteps, resamplings,
                                                jump_length, inpaint=True))

        xh0_l = core.normalize_xh(torch.cat([ligand.x, ligand.h], -1), lm)
        xh0_p = core.normalize_xh(torch.cat([pocket.x, pocket.h], -1), pm)
        den = ((lf.sum(1) + pf.sum(1)).clamp_min(1e-9))

        def fixed_com(a_l, a_p):
            num = (a_l[..., :nd] * lf).sum(1) + (a_p[..., :nd] * pf).sum(1)
            return (num / den)[:, None, :]

        # centre on the centre of mass of the known parts
        mean_known = fixed_com(xh0_l, xh0_p)
        xh0_l = _with_x(xh0_l, (xh0_l[..., :nd] - mean_known) * lm[..., None],
                        nd)
        xh0_p = _with_x(xh0_p, (xh0_p[..., :nd] - mean_known) * pm[..., None],
                        nd)
        z_l, z_p = core.sample_joint_noise(lm, pm, draws.next(), generator)

        def norm_t(step):
            return torch.full((b,), float(step), device=device) / timesteps

        schedule = get_repaint_schedule(resamplings, jump_length, timesteps)
        s = timesteps - 1
        for i, n_steps in enumerate(schedule):
            for _ in range(n_steps):
                with annotate("sampler.step"):
                    s_norm, t_norm = norm_t(s), norm_t(s + 1)
                    gamma_s = core.schedule(s_norm)
                    zl_un, zp_un = core.sample_p_zs_given_zt(
                        s_norm, t_norm, z_l, z_p, lm, pm, self._eps,
                        noise=draws.next(), generator=generator)
                    zl_kn, zp_kn, _, _ = core.noised_representation(
                        xh0_l, xh0_p, lm, pm, gamma_s, draws.next(), generator)
                    d = fixed_com(zl_un, zp_un) - fixed_com(zl_kn, zp_kn)
                    zl_kn = _with_x(
                        zl_kn, (zl_kn[..., :nd] + d) * lm[..., None], nd)
                    zp_kn = _with_x(
                        zp_kn, (zp_kn[..., :nd] + d) * pm[..., None], nd)
                    z_l = (zl_kn * lf + zl_un * (1 - lf)) * lm[..., None]
                    z_p = (zp_kn * pf + zp_un * (1 - pf)) * pm[..., None]
                    s -= 1
            if i < len(schedule) - 1:
                # jump back: re-noise the last denoised level s + 1 up to
                # s + 1 + jump_length, then denoise on from there
                s_denoised = s + 1
                t_next = s_denoised + jump_length
                z_l, z_p = core.sample_p_zt_given_zs(
                    z_l, z_p, lm, pm, core.schedule(norm_t(t_next)),
                    core.schedule(norm_t(s_denoised)), draws.next(),
                    generator)
                s = t_next - 1

        with annotate("decode"):
            x_l, h_l, x_p, h_p = core.sample_p_xh_given_z0(
                z_l, z_p, lm, pm, self._eps, noise=draws.next(),
                generator=generator)
            x_l, x_p = remove_mean_joint(x_l, x_p, lm, pm)
        return NodeBatch(x_l, h_l, lm), NodeBatch(x_p, h_p, pm)
