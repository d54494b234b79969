"""Unguided pocket-conditional sampling: a Python loop of T reverse steps,
one denoiser forward each, then the final decode."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from diffndm_tpu_torch.config import SampleConfig
from diffndm_tpu_torch.diffusion.core import (CondDiffusion,
                                              init_ligand_from_pocket)
from diffndm_tpu_torch.ops.segment import masked_mean, remove_mean_ligand
from diffndm_tpu_torch.structs import NodeBatch, pad_to


class SampleResult(NamedTuple):
    ligand: NodeBatch       # decoded ligand, in the original pocket frame
    pocket: NodeBatch       # pocket, shifted back to the original frame


class SamplerNoise(NamedTuple):
    """Fixed noise for one trajectory, each [B, NL, 3 + atom_nf]:
    ``init`` for the initial ligand, ``steps[s]`` for reverse step s
    (steps is [T, B, NL, F]), ``decode`` for the final decode."""
    init: torch.Tensor
    steps: torch.Tensor
    decode: torch.Tensor


class ConditionalSampler:
    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module,
                 cfg: SampleConfig):
        self.core = core
        self.dynamics = dynamics
        self.cfg = cfg

    def ligand_mask(self, num_nodes_lig, device) -> torch.Tensor:
        """[B, NL] mask; NL is the largest size rounded up to
        ``lig_pad_multiple``."""
        sizes = np.asarray(num_nodes_lig)
        nl = pad_to(int(sizes.max()), self.cfg.lig_pad_multiple)
        mask = (np.arange(nl)[None, :] < sizes[:, None]).astype(np.float32)
        return torch.from_numpy(mask).to(device)

    def _eps(self, z_lig, xh_pocket, t, lig_mask, pocket_mask):
        return self.dynamics(z_lig, xh_pocket, t, lig_mask, pocket_mask)

    @torch.no_grad()
    def sample_given_pocket(self, pocket: NodeBatch, num_nodes_lig,
                            timesteps: Optional[int] = None,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[SamplerNoise] = None
                            ) -> SampleResult:
        """Generate ligands for a padded, batched pocket.

        num_nodes_lig: [B] ligand sizes.  timesteps: reverse steps (default
        the schedule's T; fewer steps read the T-step table at round(t*T)).
        generator draws the noise unless ``noise`` fixes it."""
        core = self.core
        timesteps = timesteps or core.schedule.timesteps
        device = pocket.x.device
        b = pocket.x.shape[0]
        lig_mask = self.ligand_mask(num_nodes_lig, device)
        pocket_mask = pocket.mask

        nx, nh = core.cfg.norm_values
        bh = core.cfg.norm_biases[1]
        p_x = pocket.x / nx * pocket_mask[..., None]
        p_h = (pocket.h - bh) / nh * pocket_mask[..., None]
        z_lig, xh_pocket = init_ligand_from_pocket(
            core, p_x, p_h, lig_mask, pocket_mask,
            noise=None if noise is None else noise.init, generator=generator)

        for s in range(timesteps - 1, -1, -1):
            s_norm = torch.full((b,), float(s), device=device) / timesteps
            t_norm = torch.full((b,), float(s + 1), device=device) / timesteps
            z_lig, xh_pocket = core.sample_p_zs_given_zt(
                s_norm, t_norm, z_lig, xh_pocket, lig_mask, pocket_mask,
                self._eps, noise=None if noise is None else noise.steps[s],
                generator=generator)

        x_lig, h_lig, x_pocket, h_pocket = core.sample_p_xh_given_z0(
            z_lig, xh_pocket, lig_mask, pocket_mask, self._eps,
            noise=None if noise is None else noise.decode,
            generator=generator)

        # centre-of-gravity drift projection, then the shift back to the
        # original pocket frame
        x_lig, x_pocket = remove_mean_ligand(x_lig, x_pocket, lig_mask,
                                             pocket_mask)
        com_before = masked_mean(pocket.x, pocket_mask, dim=1, keepdim=True)
        com_after = masked_mean(x_pocket, pocket_mask, dim=1, keepdim=True)
        shift = com_before - com_after
        x_lig = (x_lig + shift) * lig_mask[..., None]
        x_pocket = (x_pocket + shift) * pocket_mask[..., None]
        return SampleResult(ligand=NodeBatch(x_lig, h_lig, lig_mask),
                            pocket=NodeBatch(x_pocket, h_pocket,
                                             pocket_mask))
