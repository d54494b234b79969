"""Pocket-conditional sampling: a Python loop of T reverse steps, one
denoiser forward each, then the final decode.  With guidance enabled a
step may be followed by an ATP prune, an SPSA update and (once) the hybrid
branch ensemble, in that order; each is decided by plain ``if``s on the
integer step index.

RL: with an AdjustNet (``adjust``) its output is added to eps at every
reverse step (and at the prunes' branch steps); with ``collect_rl`` the
loop also stacks each step's (z_t, eps) for the REINFORCE update
``rl_update`` makes after decoding."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffndm_tpu_torch.config import SampleConfig
from diffndm_tpu_torch.diffusion.core import (CondDiffusion,
                                              init_ligand_from_pocket)
from diffndm_tpu_torch.guidance.atp import atp_prune, hybrid_spsa_prune
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.guidance.spsa import spsa_update
from diffndm_tpu_torch.ops.segment import masked_mean, remove_mean_ligand
from diffndm_tpu_torch.structs import NodeBatch, pad_to


class SampleResult(NamedTuple):
    """ATP selection can replicate a candidate across batch rows and drop
    another, so the masks are those of the rows that survived and
    ``row_src`` [B] names the input row each output row descends from.
    ``avg_log_prob`` is the mean over the T main steps of the adjustment's
    log-prob proxy (0 without one); ``rl_traj`` the (z_t, eps) stacks
    [T, B, NL, F] of the main steps, z_t before the step and its prunes,
    eps before adjustment, in step order T-1 .. 0 (None unless
    collected)."""
    ligand: NodeBatch       # decoded ligand, in the original pocket frame
    pocket: NodeBatch       # pocket, shifted back to the original frame
    row_src: torch.Tensor
    avg_log_prob: torch.Tensor
    rl_traj: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class SamplerNoise(NamedTuple):
    """Fixed noise for one trajectory.  Each of [B, NL, 3 + atom_nf]:
    ``init`` for the initial ligand, ``steps[s]`` for reverse step s
    (steps is [T, B, NL, F]), ``decode`` for the final decode.  Guidance
    events, by step index (every event that fires must have an entry):
    ``atp[s]`` the branches' step noise [G-1, B, NL, F], ``spsa[s]`` the k
    probe draws [k, B, NL, 3], ``hybrid`` the pair (branch step noise
    [G-1, B, NL, F], per-branch probe draws [G-1, k, B, NL, 3])."""
    init: torch.Tensor
    steps: torch.Tensor
    decode: torch.Tensor
    atp: Optional[Dict[int, torch.Tensor]] = None
    spsa: Optional[Dict[int, torch.Tensor]] = None
    hybrid: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def guidance_events(cfg: SampleConfig, timesteps: int) -> dict:
    """The step indices at which each guidance event fires."""
    steps = range(timesteps - 1, -1, -1)
    atp = [s for s in steps if cfg.atp.enabled and s <= cfg.atp.start_step
           and s % cfg.atp.every == 0]
    spsa = [s for s in steps if cfg.spsa.enabled
            and s <= cfg.spsa.start_step and s % cfg.spsa.every == 0]
    hybrid = [s for s in spsa if cfg.spsa.hybrid_prune
              and s == cfg.spsa.start_step]
    return dict(atp=atp, spsa=spsa, hybrid=hybrid)


def count_forwards(cfg: SampleConfig, timesteps: int) -> int:
    """Denoiser forwards of one ``sample_given_pocket`` call: one per step
    and the decode; per SPSA update one (fused) or k; per prune one for
    the G-1 branches and one for the G lookaheads; the hybrid adds an SPSA
    update per branch."""
    ev = guidance_events(cfg, timesteps)
    per_spsa = 1 if cfg.spsa.fuse_probes else cfg.spsa.num_probes
    g_extra = cfg.atp.num_groups - 1
    per_prune = (1 if g_extra else 0) + 1
    return (timesteps + 1 + per_prune * len(ev["atp"])
            + per_spsa * len(ev["spsa"])
            + (per_prune + g_extra * per_spsa) * len(ev["hybrid"]))


class ConditionalSampler:
    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module,
                 cfg: SampleConfig, oracle: Optional[RewardOracle] = None):
        """oracle: the reward oracle; needed when ``cfg`` enables
        guidance, and by ``rl_update``."""
        if (cfg.spsa.enabled or cfg.atp.enabled) and oracle is None:
            raise ValueError("guided sampling needs a reward oracle")
        self.core = core
        self.dynamics = dynamics
        self.cfg = cfg
        self.oracle = oracle

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
                            noise: Optional[SamplerNoise] = None,
                            adjust=None,
                            collect_rl: bool = False) -> SampleResult:
        """Generate ligands for a padded, batched pocket, guided as the
        sampler's config says.

        num_nodes_lig: [B] ligand sizes.  timesteps: reverse steps (default
        the config's ``timesteps``, else the schedule's T; fewer steps read
        the T-step table at round(t*T)).  generator draws the noise unless
        ``noise`` fixes it.  adjust: the AdjustNet (any z -> adjustment
        callable), applied at every step when given; collect_rl: keep the
        stacks ``rl_update`` needs."""
        core = self.core
        timesteps = timesteps or self.cfg.timesteps or core.schedule.timesteps
        device = pocket.x.device
        b = pocket.x.shape[0]
        lig_mask = self.ligand_mask(num_nodes_lig, device)
        pocket_mask = pocket.mask

        def fixed(name, s=None):
            """The fixed noise of an event, or None where it is drawn."""
            if noise is None:
                return None
            table = getattr(noise, name)
            if table is None:
                raise ValueError(f"SamplerNoise.{name} is missing, and the "
                                 f"event fires at step {s}")
            return table if s is None else table[s]

        nx, nh = core.cfg.norm_values
        bh = core.cfg.norm_biases[1]
        p_x = pocket.x / nx * pocket_mask[..., None]
        p_h = (pocket.h - bh) / nh * pocket_mask[..., None]
        z_lig, xh_pocket = init_ligand_from_pocket(
            core, p_x, p_h, lig_mask, pocket_mask,
            noise=fixed("init"), generator=generator)

        cfg, oracle = self.cfg, self.oracle
        events = guidance_events(cfg, timesteps)
        pocket_mask0 = pocket_mask
        row_src = torch.arange(b, device=device)
        lp_sum = z_lig.new_zeros(())
        traj = ((z_lig.new_empty((timesteps,) + z_lig.shape),
                 z_lig.new_empty((timesteps,) + z_lig.shape))
                if collect_rl else None)

        for s in range(timesteps - 1, -1, -1):
            s_norm = torch.full((b,), float(s), device=device) / timesteps
            t_norm = torch.full((b,), float(s + 1), device=device) / timesteps
            if collect_rl:
                traj[0][timesteps - 1 - s] = z_lig
            z_lig, xh_pocket, lp, eps = core.sample_p_zs_given_zt(
                s_norm, t_norm, z_lig, xh_pocket, lig_mask, pocket_mask,
                self._eps, adjust_fn=adjust, noise=fixed("steps", s),
                generator=generator, noise_scale=cfg.noise_scale)
            if adjust is not None:
                lp_sum += lp
            if collect_rl:
                traj[1][timesteps - 1 - s] = eps

            if s in events["atp"]:
                z_lig, xh_pocket, lig_mask, pocket_mask, sel = atp_prune(
                    core, self._eps, oracle, z_lig, xh_pocket, lig_mask,
                    pocket_mask, s_norm, t_norm, s, cfg.atp,
                    noise=fixed("atp", s), generator=generator,
                    noise_scale=cfg.noise_scale, adjust_fn=adjust)
                row_src = row_src[sel % b]

            if s in events["spsa"]:
                # float32 arithmetic, as the latents are
                zeta = float(np.float32(cfg.spsa.zeta0) * np.float32(s)
                             / np.float32(cfg.spsa.zeta_denom))
                z_lig, xh_pocket = spsa_update(
                    core, self._eps, oracle, z_lig, xh_pocket, lig_mask,
                    pocket_mask, t_norm, zeta, cfg.spsa,
                    noise=fixed("spsa", s),
                    generator=generator)
                if s in events["hybrid"]:
                    branch, probes = fixed("hybrid") or (None, None)
                    (z_lig, xh_pocket, lig_mask, pocket_mask,
                     sel) = hybrid_spsa_prune(
                        core, self._eps, oracle, z_lig, xh_pocket, lig_mask,
                        pocket_mask, s_norm, t_norm, s, cfg.atp, cfg.spsa,
                        zeta, noise=branch, spsa_noise=probes,
                        generator=generator, noise_scale=cfg.noise_scale,
                        adjust_fn=adjust)
                    row_src = row_src[sel % b]

        x_lig, h_lig, x_pocket, h_pocket = core.sample_p_xh_given_z0(
            z_lig, xh_pocket, lig_mask, pocket_mask, self._eps,
            noise=fixed("decode"), generator=generator)

        # centre-of-gravity drift projection, then the shift back to the
        # original pocket frame
        x_lig, x_pocket = remove_mean_ligand(x_lig, x_pocket, lig_mask,
                                             pocket_mask)
        com_before = masked_mean(pocket.x, pocket_mask0, dim=1,
                                 keepdim=True)[row_src]
        com_after = masked_mean(x_pocket, pocket_mask, dim=1, keepdim=True)
        shift = com_before - com_after
        x_lig = (x_lig + shift) * lig_mask[..., None]
        x_pocket = (x_pocket + shift) * pocket_mask[..., None]
        return SampleResult(ligand=NodeBatch(x_lig, h_lig, lig_mask),
                            pocket=NodeBatch(x_pocket, h_pocket,
                                             pocket_mask),
                            row_src=row_src,
                            avg_log_prob=lp_sum / max(timesteps, 1),
                            rl_traj=traj)

    def rl_update(self, adjust_state, result: SampleResult):
        """The REINFORCE update of the AdjustNet after a generation with
        ``collect_rl``: the reward is the batch mean of the RL profile on
        the decoded ligands; the stacks are masked by the final ligand
        masks.  Returns (loss, grad_norm, reward)."""
        if result.rl_traj is None:
            raise ValueError("rl_update needs a result sampled with "
                             "collect_rl=True")
        if self.oracle is None:
            raise ValueError("rl_update needs a reward oracle")
        cfg = self.cfg.rl
        lig = result.ligand
        reward = self.oracle.rl_reward_host(lig.x, lig.h, lig.mask, cfg)
        z_stack, eps_stack = result.rl_traj
        loss, grad_norm = adjust_state.reinforce(
            z_stack, eps_stack, lig.mask, reward, cfg.reward_scale)
        return loss, grad_norm, reward
