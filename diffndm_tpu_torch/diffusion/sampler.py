"""Pocket-conditional sampling: a Python loop of T reverse steps, one
denoiser forward each, then the final decode.  With guidance enabled a
step may be followed by an ATP prune, an SPSA update and (once) the hybrid
branch ensemble, in that order; each is decided by plain ``if``s on the
integer step index.

RL: with an AdjustNet (``adjust``) its output is added to eps at every
reverse step (and at the prunes' branch steps); with ``collect_rl`` the
loop also stacks each step's (z_t, eps) for the REINFORCE update
``rl_update`` makes after decoding.

The guidance fan-out forwards (SPSA's probe batch, the prunes' branches
and lookaheads, the hybrid's) run with ``SampleConfig.fanout_row_tile``
as their band tile where it is set (``fanout_eps``, the JAX package's
host-orchestrated loop); the steps and the decode keep the denoiser's own.
``set_frame_tap`` installs a per-step callback (``make_sdf_frame_tap``
dumps the trajectory as SDF files).  Each reverse step (with its
guidance events and frame tap) is a ``sampler.step`` span, the decode a
``decode`` span, the guidance events' phases spans of their own
(``utils.profiling``); ``DIFFNDM_GUIDED_PROFILE=1`` also prints the wall
clock of the loop's phases once per call
(``utils.profiling.PhaseProfiler``).

Data-parallel (``group``, the JAX sampler's mesh): every rank passes the
global pocket batch and samples its own contiguous rows; the noise is
taken at the global shape (from ``SamplerNoise`` or, in the same order,
from the generator) and sliced, so the ranks together compute what one
process computes on the whole batch.  SPSA is per row and stays local;
ATP's selection crosses the ranks (``guidance.atp``); the result is the
whole batch, all-gathered.  Every rank makes the forwards
``count_forwards`` counts.  The REINFORCE update stays single-process, as
the JAX package's CLIs pass no mesh."""

from __future__ import annotations

import os
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
from diffndm_tpu_torch.parallel.mesh import (DataGroup, all_gather_rows,
                                             all_reduce_flat, shard_rows)
from diffndm_tpu_torch.structs import NodeBatch, pad_to
from diffndm_tpu_torch.utils.profiling import PhaseProfiler, annotate

# the batch axis of each SamplerNoise table (of one step's entry)
_NOISE_BATCH_AXIS = dict(init=0, steps=0, decode=0, atp=1, spsa=1)


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


def fanout_eps(dynamics: torch.nn.Module, cfg: SampleConfig, eps):
    """The eps function of the guidance fan-out forwards: ``eps`` where
    ``cfg.fanout_row_tile`` is unset or equals the denoiser's
    ``row_tile``, else the same weights with the fan-out's tile and, under
    a band, the window widened by the tiles' difference where the tile
    grows.  The window is centred per tile, so a wider tile alone would
    narrow each row's guaranteed half-width (window - tile) / 2; widening
    the window as much keeps it, and a window exact for the steps stays
    exact for the fan-out."""
    tile, base = cfg.fanout_row_tile, dynamics.cfg
    if not tile or tile == base.row_tile:
        return eps
    window = base.band_window
    if window is not None and tile > base.row_tile:
        window += tile - base.row_tile
    band = (tile, window)

    def fn(z_lig, xh_pocket, t, lig_mask, pocket_mask):
        return dynamics(z_lig, xh_pocket, t, lig_mask, pocket_mask,
                        band=band)
    return fn


class ConditionalSampler:
    def __init__(self, core: CondDiffusion, dynamics: torch.nn.Module,
                 cfg: SampleConfig, oracle: Optional[RewardOracle] = None,
                 group: Optional[DataGroup] = None):
        """oracle: the reward oracle; needed when ``cfg`` enables
        guidance, and by ``rl_update``.  group: sample data-parallel over
        its ranks (the batch must split evenly over them)."""
        if (cfg.spsa.enabled or cfg.atp.enabled) and oracle is None:
            raise ValueError("guided sampling needs a reward oracle")
        self.core = core
        self.dynamics = dynamics
        self.cfg = cfg
        self.oracle = oracle
        self.group = group
        self.frame_tap = None

    def set_frame_tap(self, fn) -> None:
        """fn(s, z_lig, xh_pocket, lig_mask) is called at the end of every
        reverse step s, after that step's guidance (with the masks of the
        rows that survived), on the sampler's tensors (e.g.
        ``make_sdf_frame_tap``); None removes it."""
        self.frame_tap = fn

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
        timesteps = (timesteps or self.cfg.timesteps
                     or self.core.schedule.timesteps)
        with self.core.run_schedule(timesteps):
            return self._sample(pocket, num_nodes_lig, timesteps, generator,
                                noise, adjust, collect_rl)

    def _sample(self, pocket: NodeBatch, num_nodes_lig, timesteps: int,
                generator, noise, adjust, collect_rl) -> SampleResult:
        core, group = self.core, self.group
        device = pocket.x.device
        lig_mask = self.ligand_mask(num_nodes_lig, device)
        pocket_all = pocket
        if group is not None:
            if collect_rl:
                raise ValueError("the REINFORCE update is single-process: "
                                 "collect_rl needs a sampler without a "
                                 "group")
            rows = group.rows(pocket.x.shape[0])
            pocket, lig_mask = shard_rows((pocket, lig_mask), group.rank,
                                          group.world)
        b = pocket.x.shape[0]
        pocket_mask = pocket.mask
        feat = (lig_mask.shape[1], core.n_dims + core.atom_nf)
        g_extra, k = self.cfg.atp.num_groups - 1, self.cfg.spsa.num_probes

        def drawn(name):
            """Under the group: the generator's draws of an event at the
            global shape, in the order one process draws them, and this
            rank's rows of them."""
            bg = b * group.world

            def draw(shape, axis):
                return torch.randn(shape, generator=generator,
                                   device=device).narrow(axis, rows.start, b)

            if name in ("init", "steps", "decode"):
                return draw((bg,) + feat, 0)
            if name == "spsa":
                return draw((k, bg, feat[0], core.n_dims), 1)
            if g_extra == 0:
                return None
            if name == "atp":
                return draw((g_extra, bg) + feat, 1)
            branch = draw((g_extra, bg) + feat, 1)
            return branch, torch.stack([
                draw((k, bg, feat[0], core.n_dims), 1)
                for _ in range(g_extra)])

        def fixed(name, s=None):
            """The fixed noise of an event (this rank's rows of it under
            the group), or None where it is drawn."""
            if noise is None:
                return None if group is None else drawn(name)
            table = getattr(noise, name)
            if table is None:
                raise ValueError(f"SamplerNoise.{name} is missing, and the "
                                 f"event fires at step {s}")
            value = table if s is None else table[s]
            if group is None:
                return value
            if name == "hybrid":
                return value[0][:, rows], value[1][:, :, rows]
            return value.narrow(_NOISE_BATCH_AXIS[name], rows.start, b)

        nx, nh = core.cfg.norm_values
        bh = core.cfg.norm_biases[1]
        p_x = pocket.x / nx * pocket_mask[..., None]
        p_h = (pocket.h - bh) / nh * pocket_mask[..., None]
        if core.simple:
            # the simple variant starts from the pocket's centre of mass
            com = masked_mean(p_x, pocket_mask, dim=1, keepdim=True)
            p_x = (p_x - com) * pocket_mask[..., None]
        z_lig, xh_pocket = init_ligand_from_pocket(
            core, p_x, p_h, lig_mask, pocket_mask,
            noise=fixed("init"), generator=generator)

        cfg, oracle = self.cfg, self.oracle
        fan_eps = fanout_eps(self.dynamics, cfg, self._eps)
        prof = PhaseProfiler.from_env(device)
        events = guidance_events(cfg, timesteps)
        event_steps = set(events["atp"]) | set(events["spsa"])
        row_src = torch.arange(b, device=device)
        if group is not None:
            row_src = row_src + rows.start
        lp_sum = z_lig.new_zeros(())
        traj = ((z_lig.new_empty((timesteps,) + z_lig.shape),
                 z_lig.new_empty((timesteps,) + z_lig.shape))
                if collect_rl else None)

        for s in range(timesteps - 1, -1, -1):
            with annotate("sampler.step"):
                s_norm = torch.full((b,), float(s), device=device) / timesteps
                t_norm = torch.full((b,), float(s + 1),
                                    device=device) / timesteps
                if collect_rl:
                    traj[0][timesteps - 1 - s] = z_lig
                if s == timesteps - 1 or s + 1 in event_steps:
                    prof.begin("segment")
                z_lig, xh_pocket, lp, eps = core.sample_p_zs_given_zt(
                    s_norm, t_norm, z_lig, xh_pocket, lig_mask, pocket_mask,
                    self._eps, adjust_fn=adjust, noise=fixed("steps", s),
                    generator=generator, noise_scale=cfg.noise_scale)
                if s == 0 or s in event_steps:
                    prof.end("segment")
                if adjust is not None:
                    lp_sum += lp
                if collect_rl:
                    traj[1][timesteps - 1 - s] = eps

                if s in events["atp"]:
                    z_lig, xh_pocket, lig_mask, pocket_mask, sel = atp_prune(
                        core, fan_eps, oracle, z_lig, xh_pocket, lig_mask,
                        pocket_mask, s_norm, t_norm, s, cfg.atp,
                        noise=fixed("atp", s), generator=generator,
                        noise_scale=cfg.noise_scale, adjust_fn=adjust,
                        group=group, prof=prof)
                    row_src = self._origin(row_src, sel, b)

                if s in events["spsa"]:
                    # float32 arithmetic, as the latents are
                    zeta = float(np.float32(cfg.spsa.zeta0) * np.float32(s)
                                 / np.float32(cfg.spsa.zeta_denom))
                    z_lig, xh_pocket = spsa_update(
                        core, fan_eps, oracle, z_lig, xh_pocket, lig_mask,
                        pocket_mask, t_norm, zeta, cfg.spsa,
                        noise=fixed("spsa", s),
                        generator=generator, prof=prof)
                    if s in events["hybrid"]:
                        branch, probes = fixed("hybrid") or (None, None)
                        (z_lig, xh_pocket, lig_mask, pocket_mask,
                         sel) = hybrid_spsa_prune(
                            core, fan_eps, oracle, z_lig, xh_pocket, lig_mask,
                            pocket_mask, s_norm, t_norm, s, cfg.atp, cfg.spsa,
                            zeta, noise=branch, spsa_noise=probes,
                            generator=generator, noise_scale=cfg.noise_scale,
                            adjust_fn=adjust, group=group, prof=prof)
                        row_src = self._origin(row_src, sel, b)
                if self.frame_tap is not None:
                    self.frame_tap(s, z_lig, xh_pocket, lig_mask)

        with prof.phase("decode"):
            x_lig, h_lig, x_pocket, h_pocket = core.sample_p_xh_given_z0(
                z_lig, xh_pocket, lig_mask, pocket_mask, self._eps,
                noise=fixed("decode"), generator=generator)

            # centre-of-gravity drift projection, then the shift back to
            # the original pocket frame
            x_lig, x_pocket = remove_mean_ligand(x_lig, x_pocket, lig_mask,
                                                 pocket_mask)
            com_before = masked_mean(pocket_all.x, pocket_all.mask, dim=1,
                                     keepdim=True)[row_src]
            com_after = masked_mean(x_pocket, pocket_mask, dim=1,
                                    keepdim=True)
            shift = com_before - com_after
            x_lig = (x_lig + shift) * lig_mask[..., None]
            x_pocket = (x_pocket + shift) * pocket_mask[..., None]
        if prof.enabled:
            print(prof.report(), flush=True)
        out = (x_lig, h_lig, lig_mask, x_pocket, h_pocket, pocket_mask,
               row_src)
        if group is not None:
            out = tuple(all_gather_rows(group, t) for t in out)
            if adjust is not None:
                # each rank's log-prob is a mean over its rows
                lp_sum = all_reduce_flat(group, [lp_sum])[0] / group.world
        return SampleResult(ligand=NodeBatch(*out[:3]),
                            pocket=NodeBatch(*out[3:6]), row_src=out[6],
                            avg_log_prob=lp_sum / max(timesteps, 1),
                            rl_traj=traj)

    def _origin(self, row_src, sel, b: int) -> torch.Tensor:
        """The input rows of the rows a prune selected: ``sel`` indexes
        the G*B candidates (global under the group; ``b`` is this rank's
        rows)."""
        group = self.group
        if group is None:
            return row_src[sel % b]
        bg = b * group.world
        if self.cfg.atp.per_sample:     # every row keeps its own candidate
            return row_src[sel % bg - group.rank * b]
        return all_gather_rows(group, row_src)[sel % bg]

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


def make_sdf_frame_tap(out_dir: str, dataset_info: dict, core: CondDiffusion,
                       every: int = 100, group: Optional[DataGroup] = None):
    """A frame tap (``ConditionalSampler.set_frame_tap``) that writes the
    trajectory's ligands to ``<out_dir>/try_<s>.sdf`` at every step s with
    s % every == 0: coordinates z[..., :3] times the coordinate norm,
    types the argmax of the type channels, bonds perceived.  The tensors
    are copied to the host at those steps only, so that the other steps
    add no synchronisation.  group: the sampler's data group; every rank
    calls the tap on its rows, which are all-gathered at a frame, and
    rank 0 writes the file."""
    from diffndm_tpu_torch.chem.bonds import build_molecules_batch
    from diffndm_tpu_torch.chem.io import write_sdf

    if group is None or group.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
    nx = core.cfg.norm_values[0]

    def tap(s, z_lig, xh_pocket, lig_mask):
        s = int(s)
        if s % every != 0:
            return
        if group is not None:
            z_lig = all_gather_rows(group, z_lig)
            lig_mask = all_gather_rows(group, lig_mask)
            if group.rank != 0:
                return
        z = z_lig.detach().cpu().numpy()
        mols = build_molecules_batch(z[..., :3] * nx, z[..., 3:].argmax(-1),
                                     lig_mask.cpu().numpy(), dataset_info)
        write_sdf(os.path.join(out_dir, f"try_{s}.sdf"), mols)

    return tap
