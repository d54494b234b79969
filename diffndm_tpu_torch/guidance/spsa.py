"""SPSA zero-order guidance of the ligand coordinates.

Each of k probes perturbs the coordinates by +zeta*d and -zeta*d (d a
random direction, zero-mean per molecule over real atoms), rolls both to
x0 with one denoiser forward, and scores them with the reward oracle.

- The gradient estimate is (f+ - f-) / (2 * ZETA_GRAD_DENOM) * pert with
  the denominator fixed at 1e-4 whatever the perturbation scale (the
  reference implementation hard-codes it).
- The update is gradient ascent with ``guidance_scale`` followed by
  re-centring on the ligand centre of mass, the pocket moved along.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffndm_tpu_torch.config import SPSAConfig
from diffndm_tpu_torch.diffusion.core import CondDiffusion, draw_noise
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.ops.segment import masked_mean, remove_mean_ligand
from diffndm_tpu_torch.utils.profiling import OFF, PhaseProfiler

ZETA_GRAD_DENOM = 1e-4


def spsa_update(core: CondDiffusion, eps_fn, oracle: RewardOracle,
                z_lig, xh_pocket, lig_mask, pocket_mask, t_norm, zeta,
                cfg: SPSAConfig, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                prof: PhaseProfiler = OFF):
    """One SPSA update.  z_lig: [B, NL, 3+F] (normalised latent); t_norm:
    scalar or [B]; noise: the k raw normal draws [k, B, NL, 3], else drawn
    from ``generator``; prof: times the ``spsa.*`` phases.  Returns the
    updated (z_lig, xh_pocket)."""
    nd = core.n_dims
    b, k = z_lig.shape[0], cfg.num_probes
    ml = lig_mask[..., None]
    nx = core.cfg.norm_values[0]
    x, feats = z_lig[..., :nd], z_lig[..., nd:]
    t = torch.as_tensor(t_norm, dtype=x.dtype, device=x.device).expand(b)

    def lookahead(x_pm, reps):
        """x_pm: [reps*B, NL, 3], the rows of ``reps`` copies of the batch
        -> their x0 lookahead."""
        z_pm = torch.cat([x_pm, feats.repeat(reps, 1, 1)], -1)
        return core.to_x0(z_pm, xh_pocket.repeat(reps, 1, 1),
                          t.repeat(reps), lig_mask.repeat(reps, 1),
                          pocket_mask.repeat(reps, 1), eps_fn)

    with prof.phase("spsa.probe"):
        raw = draw_noise(x.new_empty((k,) + x.shape), noise, generator) * ml
        raw = (raw - masked_mean(raw, ml.expand_as(raw), dim=2,
                                 keepdim=True)) * ml
        perts = zeta * raw                                # [k, B, NL, 3]
        if cfg.fuse_probes:
            # one forward of k*2B rows, ordered [k, 2, B]: per probe the
            # B plus rows, then the B minus rows
            x_pm = torch.stack([x + perts, x - perts], dim=1)
            z0s = [lookahead(x_pm.reshape((2 * k * b,) + x.shape[1:]),
                             2 * k)]
        else:
            z0s = [lookahead(torch.cat([x + p, x - p]), 2) for p in perts]
    reps = 2 * k // len(z0s)
    with prof.phase("spsa.fetch"):
        z0s = [prof.fetch(z0) for z0 in z0s]
        lm = prof.fetch(lig_mask).repeat(reps, 1)
    with prof.phase("spsa.score"):
        r = torch.cat([oracle.spsa_rewards(z0[..., :nd] * nx, z0[..., nd:],
                                           lm, cfg) for z0 in z0s])
    with prof.phase("spsa.apply"):
        r = r.to(x.device).reshape(k, 2, b)
        dd = (r[:, 0] - r[:, 1]) / (2.0 * ZETA_GRAD_DENOM)  # [k, B]
        avg_grad = (dd[:, :, None, None] * perts).mean(dim=0)
        new_x, px = remove_mean_ligand(x + cfg.guidance_scale * avg_grad,
                                       xh_pocket[..., :nd], lig_mask,
                                       pocket_mask)
        return (torch.cat([new_x, feats], -1) * ml,
                torch.cat([px, xh_pocket[..., nd:]], -1))
