"""RePaint inpainting: fragment-constrained generation.

A fixed substructure (``lig_fixed``, a [B, NL] mask inside the ligand
mask; padding rows never count as fixed) is kept while the rest of the
ligand is generated around it.  One plain Python loop runs over the
steps s = T-1 .. 0 and, inside each, over the resamplings u = 0 .. R-1.
Each (s, u) iteration:

1. one reverse step t -> s of the whole ligand (the denoised "unknown");
2. with SPSA enabled, at ``spsa_low <= s <= spsa_high`` and u == 0: an
   SPSA update of the *pre-step* z (with the post-step pocket), which
   *replaces* the denoised unknown (the reference implementation does
   this; when the hook does not fire the denoised unknown stays);
3. ``repaint_combine``: the known part is the input fragment, shifted by
   the drift of the pocket's centre of mass since the start, re-noised at
   gamma_s; its fixed-atom centre of mass is aligned onto the unknown
   part's (the pocket moved along); known and unknown are combined
   through the fixed mask; between resamplings (u < R-1) the result is
   re-noised s -> t.

After the resamplings of step s, with ATP enabled, at ``s <=
atp_start_step`` and ``s % atp_every == 0``, a prune selects B of the G*B
candidates (settings from ``cfg.atp``); every per-row quantity the loop
carries (fixed mask, clean fragment, initial pocket centre, origin row)
is gathered by the selection.

The hooks' fan-out forwards (SPSA's probe batch, ATP's branches and
lookaheads) run with ``SampleConfig.fanout_row_tile`` as their band tile
where it is set (``sampler.fanout_eps``), as the JAX package's
host-orchestrated inpainting loop runs them.  Each step s (its
resamplings and prune) is a ``sampler.step`` span, the decode a
``decode`` span, the hooks' phases spans of their own
(``utils.profiling``); ``DIFFNDM_GUIDED_PROFILE=1`` also times the hooks'
phases (``spsa.*``, ``atp.*``, the phases that loop times) and prints
them once per call.

Noise: every draw comes from ``generator`` unless ``InpaintNoise`` fixes
it, entry by entry (the replay tests feed the draws of the JAX package's
key schedule).  ``noise_scale`` scales the reverse steps and the ATP
branches only; the known-part noise and the re-noising stay exact.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from diffndm_tpu_torch.config import SampleConfig
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.diffusion.sampler import SampleResult, fanout_eps
from diffndm_tpu_torch.guidance.atp import atp_prune
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.guidance.spsa import spsa_update
from diffndm_tpu_torch.ops.segment import masked_mean
from diffndm_tpu_torch.structs import NodeBatch
from diffndm_tpu_torch.utils.profiling import PhaseProfiler, annotate


def _fixed_mean(x, fixed):
    """Mean of x [B, NL, D] over the fixed atoms (fixed: [B, NL, 1])."""
    fsum = fixed.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return (x * fixed).sum(dim=1, keepdim=True) / fsum


def repaint_combine(core: CondDiffusion, z_unknown, xh_pocket, lig_mask,
                    pocket_mask, fixed, l_x, l_h, com_p0, gamma_s, gamma_t,
                    u: int, resamplings: int, noise_known=None,
                    noise_renoise=None, generator=None):
    """The tail of one (s, u) iteration.  fixed: [B, NL, 1]; l_x, l_h the
    clean normalised fragment; com_p0 [B, 1, 3] the pocket's centre at the
    start; gamma_s, gamma_t: [B].  noise_known: the known part's noise;
    noise_renoise: the re-noising's (drawn only for u < resamplings - 1).
    Returns (z, xh_pocket)."""
    nd = core.n_dims
    ml = lig_mask[..., None]
    mp = pocket_mask[..., None]
    com_pocket = masked_mean(xh_pocket[..., :nd], pocket_mask, dim=1,
                             keepdim=True)
    xh_ligand = torch.cat([(l_x + (com_pocket - com_p0)) * ml, l_h], -1)
    z_known, xh_pocket, _ = core.noised_representation(
        xh_ligand, xh_pocket, lig_mask, pocket_mask, gamma_s,
        noise=noise_known, generator=generator)

    dx = _fixed_mean(z_unknown[..., :nd], fixed) \
        - _fixed_mean(z_known[..., :nd], fixed)
    z_known = torch.cat([(z_known[..., :nd] + dx) * ml, z_known[..., nd:]],
                        -1)
    xh_pocket = torch.cat([(xh_pocket[..., :nd] + dx) * mp,
                           xh_pocket[..., nd:]], -1)
    z = (z_known * fixed + z_unknown * (1.0 - fixed)) * ml
    if u < resamplings - 1:
        z, xh_pocket = core.sample_p_zt_given_zs(
            z, xh_pocket, lig_mask, pocket_mask, gamma_t, gamma_s,
            noise=noise_renoise, generator=generator)
    return z, xh_pocket


class InpaintNoise(NamedTuple):
    """Fixed noise for one inpainting run, each draw [B, NL, 3 + atom_nf]
    unless said otherwise: ``init`` the initial ligand; by step s and
    resampling u, ``steps[s][u]`` the reverse step, ``known[s][u]`` the
    known part's and ``renoise[s][u]`` the re-noising's (u < R-1 only:
    [T, R-1, ...]); ``decode`` the final decode.  Guidance events by step
    (every event that fires must have an entry): ``spsa[s]`` the k probe
    draws [k, B, NL, 3], ``atp[s]`` the branches' step noise
    [G-1, B, NL, 3 + atom_nf]."""
    init: torch.Tensor
    steps: torch.Tensor
    known: torch.Tensor
    renoise: torch.Tensor
    decode: torch.Tensor
    spsa: Optional[Dict[int, torch.Tensor]] = None
    atp: Optional[Dict[int, torch.Tensor]] = None


def inpaint_events(cfg: SampleConfig, timesteps: int, svdd: bool,
                   spsa: bool) -> dict:
    """The steps at which each guidance hook fires (SPSA at u == 0 of the
    step, ATP after its resamplings)."""
    icfg = cfg.inpaint
    steps = range(timesteps - 1, -1, -1)
    return dict(
        spsa=[s for s in steps if spsa
              and icfg.spsa_low <= s <= icfg.spsa_high],
        atp=[s for s in steps if svdd and s <= icfg.atp_start_step
             and s % icfg.atp_every == 0])


def count_inpaint_forwards(cfg: SampleConfig, timesteps: int,
                           resamplings: int, svdd: bool, spsa: bool) -> int:
    """Denoiser forwards of one ``inpaint`` call: one per (s, u) and the
    decode; per SPSA update one (fused) or k; per prune one for the G-1
    branches and one for the G lookaheads."""
    ev = inpaint_events(cfg, timesteps, svdd, spsa)
    per_spsa = 1 if cfg.spsa.fuse_probes else cfg.spsa.num_probes
    per_prune = (1 if cfg.atp.num_groups > 1 else 0) + 1
    return (timesteps * resamplings + 1 + per_spsa * len(ev["spsa"])
            + per_prune * len(ev["atp"]))


class InpaintSampler:
    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module,
                 cfg: SampleConfig, oracle: Optional[RewardOracle] = None):
        """oracle: the reward oracle; needed by a guided call."""
        self.core = core
        self.dynamics = dynamics
        self.cfg = cfg
        self.oracle = oracle

    def _eps(self, z_lig, xh_pocket, t, lig_mask, pocket_mask):
        return self.dynamics(z_lig, xh_pocket, t, lig_mask, pocket_mask)

    @torch.no_grad()
    def inpaint(self, ligand: NodeBatch, lig_fixed: torch.Tensor,
                pocket: NodeBatch, timesteps: Optional[int] = None,
                resamplings: Optional[int] = None, svdd: bool = False,
                spsa: Optional[bool] = None, center: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[InpaintNoise] = None) -> SampleResult:
        """Complete the ligands around their fixed atoms.

        ligand: the padded input (fixed atoms' coordinates and types; the
        mask sets the final sizes); lig_fixed: [B, NL], 1.0 on the fixed
        atoms; timesteps: reverse steps over the T-step schedule (default
        T); resamplings: per step (default ``cfg.inpaint.resamplings``);
        svdd / spsa: the ATP and SPSA hooks (spsa defaults to
        ``cfg.spsa.enabled``); center: the initial ligand is drawn around
        the fixed atoms' centre ("ligand") or the pocket's ("pocket";
        default ``cfg.inpaint.center``).

        The decoded ligand is shifted back to the input pocket frame of
        its origin row without a further centre-of-mass projection (the
        JAX package's fused loop; its host-orchestrated loop projects
        first, which after the shift differs only by rounding)."""
        core, cfg, icfg = self.core, self.cfg, self.cfg.inpaint
        timesteps = timesteps or core.schedule.timesteps
        resamplings = resamplings or icfg.resamplings
        center = center or icfg.center
        spsa = cfg.spsa.enabled if spsa is None else spsa
        if (svdd or spsa) and self.oracle is None:
            raise ValueError("guided inpainting needs a reward oracle")
        if center not in ("ligand", "pocket"):
            raise ValueError(f"center must be 'ligand' or 'pocket', got "
                             f"{center!r}")
        device = pocket.x.device
        b = ligand.x.shape[0]

        def fixed_noise(name, s=None, u=None):
            """The fixed draw of an entry, or None where it is drawn."""
            if noise is None:
                return None
            table = getattr(noise, name)
            if table is None or (isinstance(table, dict) and s not in table):
                raise ValueError(f"InpaintNoise.{name} is missing an entry "
                                 f"for step {s}")
            if s is None:
                return table
            return table[s] if u is None else table[s][u]

        nx, nh = core.cfg.norm_values
        bh = core.cfg.norm_biases[1]
        lm, pm = ligand.mask, pocket.mask
        ml, mp = lm[..., None], pm[..., None]
        fixed = (lig_fixed.to(ligand.x.dtype) * lm)[..., None]
        l_x = ligand.x / nx * ml
        l_h = (ligand.h - bh) / nh * ml
        p_x = pocket.x / nx * mp
        p_h = (pocket.h - bh) / nh * mp
        com_p0 = masked_mean(p_x, pm, dim=1, keepdim=True)
        mean_known = (_fixed_mean(l_x, fixed) if center == "ligand"
                      else com_p0)
        nl = lm.shape[1]
        mu = torch.cat([mean_known.expand(b, nl, core.n_dims),
                        l_x.new_zeros(b, nl, core.atom_nf)], -1) * ml
        z, xh_p = core.sample_normal_zero_com(
            mu, torch.cat([p_x, p_h], -1), torch.ones(b, device=device), lm,
            pm, noise=fixed_noise("init"), generator=generator)

        events = inpaint_events(cfg, timesteps, svdd, spsa)
        fan_eps = fanout_eps(self.dynamics, cfg, self._eps)
        prof = PhaseProfiler.from_env(device)
        row_src = torch.arange(b, device=device)
        for s in range(timesteps - 1, -1, -1):
            with annotate("sampler.step"):
                s_norm = torch.full((b,), float(s), device=device) / timesteps
                t_norm = torch.full((b,), float(s + 1),
                                    device=device) / timesteps
                gamma_s, gamma_t = core.schedule(s_norm), core.schedule(t_norm)
                for u in range(resamplings):
                    z_unknown, xh_p, _, _ = core.sample_p_zs_given_zt(
                        s_norm, t_norm, z, xh_p, lm, pm, self._eps,
                        noise=fixed_noise("steps", s, u), generator=generator,
                        noise_scale=cfg.noise_scale)
                    if u == 0 and s in events["spsa"]:
                        # float32 arithmetic, as the latents are
                        zeta = float(np.float32(cfg.spsa.zeta0) * np.float32(s)
                                     / np.float32(icfg.spsa_zeta_denom))
                        z_unknown, xh_p = spsa_update(
                            core, fan_eps, self.oracle, z, xh_p, lm, pm,
                            t_norm, zeta, cfg.spsa,
                            noise=fixed_noise("spsa", s), generator=generator,
                            prof=prof)
                    renoise = u < resamplings - 1
                    z, xh_p = repaint_combine(
                        core, z_unknown, xh_p, lm, pm, fixed, l_x, l_h, com_p0,
                        gamma_s, gamma_t, u, resamplings,
                        noise_known=fixed_noise("known", s, u),
                        noise_renoise=(fixed_noise("renoise", s, u) if renoise
                                       else None),
                        generator=generator)
                if s in events["atp"]:
                    z, xh_p, lm, pm, sel = atp_prune(
                        core, fan_eps, self.oracle, z, xh_p, lm, pm, s_norm,
                        t_norm, s, cfg.atp, noise=fixed_noise("atp", s),
                        generator=generator, noise_scale=cfg.noise_scale,
                        prof=prof)
                    rs = sel % b
                    fixed, l_x, l_h, com_p0 = (fixed[rs], l_x[rs], l_h[rs],
                                               com_p0[rs])
                    row_src = row_src[rs]

        with annotate("decode"):
            x_lig, h_lig, x_pocket, h_pocket = core.sample_p_xh_given_z0(
                z, xh_p, lm, pm, self._eps, noise=fixed_noise("decode"),
                generator=generator)
            com_before = masked_mean(pocket.x, pocket.mask, dim=1,
                                     keepdim=True)[row_src]
            shift = com_before - masked_mean(x_pocket, pm, dim=1,
                                             keepdim=True)
        if prof.enabled:
            print(prof.report(), flush=True)
        return SampleResult(
            ligand=NodeBatch((x_lig + shift) * lm[..., None], h_lig, lm),
            pocket=NodeBatch((x_pocket + shift) * pm[..., None], h_pocket,
                             pm),
            row_src=row_src, avg_log_prob=x_lig.new_zeros(()))
