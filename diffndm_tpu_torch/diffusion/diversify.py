"""Partial noise-then-denoise diversification, the step of the
evolutionary optimizer: a ligand is noised to step ``noising_steps`` of
the model's T-step schedule and denoised back through that many reverse
steps, which keeps it near its pose while changing its details.  Each
reverse step is a ``sampler.step`` span and the decode a ``decode`` span
(``utils.profiling``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.diffusion.sampler import SampleResult
from diffndm_tpu_torch.ops.segment import masked_mean, remove_mean_ligand
from diffndm_tpu_torch.structs import NodeBatch
from diffndm_tpu_torch.utils.profiling import annotate


class DiversifyNoise(NamedTuple):
    """Fixed noise for one diversification, each [B, NL, 3 + atom_nf]:
    ``noised`` the forward noising, ``steps[s]`` reverse step s
    ([noising_steps, B, NL, F]), ``decode`` the final decode."""
    noised: torch.Tensor
    steps: torch.Tensor
    decode: torch.Tensor


class DiversifySampler:
    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module):
        self.core = core
        self.dynamics = dynamics

    def _eps(self, z_lig, xh_pocket, t, lig_mask, pocket_mask):
        return self.dynamics(z_lig, xh_pocket, t, lig_mask, pocket_mask)

    @torch.no_grad()
    def diversify(self, ligand: NodeBatch, pocket: NodeBatch,
                  noising_steps: int,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[DiversifyNoise] = None) -> SampleResult:
        """Noise each ligand to gamma(noising_steps) (centred on its own
        centre of mass), run noising_steps reverse steps at s / T, decode
        and shift back to the input pocket frame.  The masks are the
        input's."""
        core = self.core
        T = core.schedule.timesteps
        nx, nh = core.cfg.norm_values
        bh = core.cfg.norm_biases[1]
        lm, pm = ligand.mask, pocket.mask
        ml, mp = lm[..., None], pm[..., None]
        b = lm.shape[0]
        device = lm.device

        l_x, p_x = remove_mean_ligand(ligand.x / nx * ml, pocket.x / nx * mp,
                                      lm, pm)
        xh_lig = torch.cat([l_x, (ligand.h - bh) / nh * ml], -1)
        xh_p = torch.cat([p_x, (pocket.h - bh) / nh * mp], -1)
        gamma_t = core.gamma_int(torch.full((b,), noising_steps,
                                            device=device))
        z, xh_p, _ = core.noised_representation(
            xh_lig, xh_p, lm, pm, gamma_t,
            noise=None if noise is None else noise.noised,
            generator=generator)
        for s in range(noising_steps - 1, -1, -1):
            with annotate("sampler.step"):
                s_norm = torch.full((b,), float(s), device=device) / T
                t_norm = torch.full((b,), float(s + 1), device=device) / T
                z, xh_p, _, _ = core.sample_p_zs_given_zt(
                    s_norm, t_norm, z, xh_p, lm, pm, self._eps,
                    noise=None if noise is None else noise.steps[s],
                    generator=generator)
        with annotate("decode"):
            x_lig, h_lig, x_pocket, h_pocket = core.sample_p_xh_given_z0(
                z, xh_p, lm, pm, self._eps,
                noise=None if noise is None else noise.decode,
                generator=generator)
            shift = (masked_mean(pocket.x, pm, dim=1, keepdim=True)
                     - masked_mean(x_pocket, pm, dim=1, keepdim=True))
        return SampleResult(
            ligand=NodeBatch((x_lig + shift) * ml, h_lig, lm),
            pocket=NodeBatch((x_pocket + shift) * mp, h_pocket, pm),
            row_src=torch.arange(b, device=device),
            avg_log_prob=x_lig.new_zeros(()))
