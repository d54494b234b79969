"""ATP: adaptive trajectory pruning (SVDD-style candidate selection).

At a prune step s (after the s-step update):

- groups = {current z_s} + (G-1) branches, each the same (s, t) transition
  applied to the pre-prune state again with fresh noise;
- each group is also rolled to x0 by a one-step lookahead;
- both decodes are scored with the SVDD reward;
- mixed reward r = r_x0 * (s/250) + r_z * (250 - s/250); the second factor
  is the reference implementation's operator-precedence quirk
  (``compat_precedence=False`` uses (250 - s)/250);
- the top-B candidates by mixed reward replace the population, with the
  masks of the rows they came from, and the ligand centre of mass is
  subtracted again.

Candidates live on a leading group axis, flattened G-major to [G*B, ...].
The G-1 branches run as one denoiser forward of (G-1)*B rows and the G
lookaheads as one of G*B rows: row by row the same arithmetic as one
forward per group, in fewer launches.  An RL adjustment (``adjust_fn``)
applies to the branch steps, not to the lookaheads or the SPSA probes.

Data-parallel (``group``, the JAX sampler's mesh): each rank holds its
rows of the population and makes their branches, lookaheads and rewards.
The global and ``group_size`` scopes select across ranks, as JAX's one
``lax.top_k`` over the sharded G*B rewards does: the mixed rewards are
all-gathered into JAX's G-major [G*B] layout, every rank runs the same
selection on all of them, then takes its selected rows from the
all-gathered candidates, z, xh and masks (a ``group_size`` group may
straddle two ranks).  ``per_sample`` keeps each row's own candidates and
stays local.  The selection then returns, for this rank's rows, indices
into the global G*B candidates.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffndm_tpu_torch.config import ATPConfig, SPSAConfig
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.guidance.spsa import spsa_update
from diffndm_tpu_torch.ops.segment import remove_mean_ligand
from diffndm_tpu_torch.parallel.mesh import DataGroup, all_gather_rows
from diffndm_tpu_torch.utils.profiling import OFF, PhaseProfiler


def _top(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, the lower index first
    among equals (early in the window most candidates are invalid and tie
    at 0; ``torch.topk`` promises no order among them)."""
    return torch.sort(values, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def select_candidates(mixed: torch.Tensor, cfg: ATPConfig,
                      b: int) -> torch.Tensor:
    """Selection indices [B] into the G*B mixed rewards (G-major).

    - default: one global top-B over all G*B candidates, only sound when
      every row shares the same pocket;
    - cfg.group_size=n: rows form contiguous groups of n sharing a pocket;
      top-n over each group's G*n candidates;
    - cfg.per_sample: the best of the G branches independently per row.
    """
    g = mixed.shape[0] // b
    rows = torch.arange(b, device=mixed.device)
    if cfg.per_sample:
        return _top(mixed.reshape(g, b).T, 1)[:, 0] * b + rows
    if cfg.group_size is not None and cfg.group_size < b:
        gs = cfg.group_size
        n_groups = b // gs
        m = mixed.reshape(g, n_groups, gs).permute(1, 0, 2).reshape(
            n_groups, g * gs)
        idx = _top(m, gs)                       # [n_groups, gs] into g*gs
        flat = (idx // gs) * b + rows[:n_groups, None] * gs + idx % gs
        return flat.reshape(b)
    return _top(mixed, b)


def gather_selected(sel_idx, z_flat, xh_flat, lig_mask, pocket_mask,
                    core: CondDiffusion):
    """The selected candidates with the masks of the batch rows they came
    from (flat index i came from row i % B), the ligand centre of mass
    subtracted again under those masks.  Returns (z, xh_pocket, lig_mask,
    pocket_mask)."""
    nd = core.n_dims
    row_src = sel_idx % lig_mask.shape[0]
    z_new, xh_new = z_flat[sel_idx], xh_flat[sel_idx]
    lm_new, pm_new = lig_mask[row_src], pocket_mask[row_src]
    zx, px = remove_mean_ligand(z_new[..., :nd], xh_new[..., :nd], lm_new,
                                pm_new)
    return (torch.cat([zx, z_new[..., nd:]], -1) * lm_new[..., None],
            torch.cat([px, xh_new[..., nd:]], -1), lm_new, pm_new)


def _branches(core, eps_fn, z_lig, xh_pocket, lig_mask, pocket_mask, s_norm,
              t_norm, n: int, noise, generator, noise_scale, adjust_fn):
    """n fresh (s, t) transitions of the same state, as one forward of n*B
    rows.  noise: [n, B, NL, 3+F] or None.  Returns [n, B, ...] stacks."""
    b = z_lig.shape[0]
    if n == 0:
        return (z_lig.new_empty((0,) + z_lig.shape),
                xh_pocket.new_empty((0,) + xh_pocket.shape))
    if noise is not None:
        noise = noise.reshape((n * b,) + tuple(noise.shape[2:]))
    z, xh, _, _ = core.sample_p_zs_given_zt(
        s_norm.repeat(n), t_norm.repeat(n), z_lig.repeat(n, 1, 1),
        xh_pocket.repeat(n, 1, 1), lig_mask.repeat(n, 1),
        pocket_mask.repeat(n, 1), eps_fn, adjust_fn=adjust_fn, noise=noise,
        generator=generator, noise_scale=noise_scale)
    return z.reshape((n, b) + z.shape[1:]), xh.reshape((n, b) + xh.shape[1:])


def _lookahead(core, eps_fn, z_groups, xh_groups, lig_mask, pocket_mask,
               t_norm):
    """The x0 lookahead of the G*B candidates, flattened G-major."""
    g = z_groups.shape[0]
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    return core.to_x0(flat(z_groups), flat(xh_groups), t_norm.repeat(g),
                      lig_mask.repeat(g, 1), pocket_mask.repeat(g, 1),
                      eps_fn)


def _score_and_select(core, oracle, z_groups, xh_groups, z0_flat, lig_mask,
                      pocket_mask, s_step: int, cfg: ATPConfig,
                      group: Optional[DataGroup] = None,
                      prof: PhaseProfiler = OFF, tag: str = "atp"):
    """Both rewards of the candidates and their lookaheads, the mixed
    weighting, selection, gather (the ``<tag>.fetch / score / select``
    phases)."""
    g, b = z_groups.shape[:2]
    nd = core.n_dims
    nx = core.cfg.norm_values[0]
    z_flat = z_groups.reshape((g * b,) + z_groups.shape[2:])
    xh_flat = xh_groups.reshape((g * b,) + xh_groups.shape[2:])
    with prof.phase(f"{tag}.fetch"):
        z_h, z0_h = prof.fetch(z_flat), prof.fetch(z0_flat)
        lm_f = prof.fetch(lig_mask).repeat(g, 1)
    with prof.phase(f"{tag}.score"):
        r_z = oracle.svdd_rewards(z_h[..., :nd] * nx, z_h[..., nd:], lm_f,
                                  cfg)
        r_x0 = oracle.svdd_rewards(z0_h[..., :nd] * nx, z0_h[..., nd:],
                                   lm_f, cfg)
    with prof.phase(f"{tag}.select"):
        r_z, r_x0 = r_z.to(z_flat.device), r_x0.to(z_flat.device)
        # the weights in float32 arithmetic, as the rewards are
        s_f, denom = np.float32(s_step), np.float32(cfg.mix_denom)
        if cfg.compat_precedence:
            w_z = denom - s_f / denom
        else:
            w_z = (denom - s_f) / denom
        mixed = r_x0 * float(s_f / denom) + r_z * float(w_z)
        if group is not None and not cfg.per_sample:
            return _select_across(group, mixed, z_groups, xh_groups,
                                  lig_mask, pocket_mask, cfg, core)
        sel_idx = select_candidates(mixed, cfg, b)
        out = gather_selected(sel_idx, z_flat, xh_flat, lig_mask,
                              pocket_mask, core)
        if group is not None:
            # per_sample: the rows' own candidates, named in the global G*B
            bg = b * group.world
            sel_idx = (sel_idx // b) * bg + group.rank * b + sel_idx % b
        return out + (sel_idx,)


def _select_across(group: DataGroup, mixed, z_groups, xh_groups, lig_mask,
                   pocket_mask, cfg: ATPConfig, core: CondDiffusion):
    """The global or per-group selection over every rank's candidates:
    returns this rank's rows as ``_score_and_select`` does, with indices
    into the global G*B."""
    g, b = z_groups.shape[:2]
    bg = b * group.world
    mixed = all_gather_rows(group, mixed.reshape(g, b), dim=1).reshape(g * bg)
    sel_idx = select_candidates(mixed, cfg, bg)[group.rows(bg)]
    z_all = all_gather_rows(group, z_groups, dim=1)
    xh_all = all_gather_rows(group, xh_groups, dim=1)
    out = gather_selected(
        sel_idx, z_all.reshape((g * bg,) + z_all.shape[2:]),
        xh_all.reshape((g * bg,) + xh_all.shape[2:]),
        all_gather_rows(group, lig_mask), all_gather_rows(group, pocket_mask),
        core)
    return out + (sel_idx,)


def atp_prune(core: CondDiffusion, eps_fn, oracle: RewardOracle, z_lig,
              xh_pocket, lig_mask, pocket_mask, s_norm, t_norm, s_step: int,
              cfg: ATPConfig, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              noise_scale: float = 1.0, adjust_fn=None,
              group: Optional[DataGroup] = None,
              prof: PhaseProfiler = OFF):
    """One pruning event.  z_lig: [B, NL, D]; s_norm, t_norm: [B]; noise:
    the branches' step noise [G-1, B, NL, D], else drawn from
    ``generator``; adjust_fn: the RL adjustment of the branch steps;
    group: select across its ranks (z_lig etc. are this rank's rows);
    prof: times the ``atp.*`` phases.  Returns (z_lig, xh_pocket,
    lig_mask, pocket_mask, sel_idx): the masks replace the caller's, and
    sel_idx % B is each output row's origin row (B the global batch under
    a group)."""
    with prof.phase("atp.cand"):
        zb, xhb = _branches(core, eps_fn, z_lig, xh_pocket, lig_mask,
                            pocket_mask, s_norm, t_norm, cfg.num_groups - 1,
                            noise, generator, noise_scale, adjust_fn)
        z_groups = torch.cat([z_lig[None], zb])
        xh_groups = torch.cat([xh_pocket[None], xhb])
        z0 = _lookahead(core, eps_fn, z_groups, xh_groups, lig_mask,
                        pocket_mask, t_norm)
    return _score_and_select(core, oracle, z_groups, xh_groups, z0,
                             lig_mask, pocket_mask, s_step, cfg, group, prof,
                             "atp")


def hybrid_spsa_prune(core: CondDiffusion, eps_fn, oracle: RewardOracle,
                      z_lig, xh_pocket, lig_mask, pocket_mask, s_norm,
                      t_norm, s_step: int, atp_cfg: ATPConfig,
                      spsa_cfg: SPSAConfig, zeta: float,
                      noise: Optional[torch.Tensor] = None,
                      spsa_noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      noise_scale: float = 1.0, adjust_fn=None,
                      group: Optional[DataGroup] = None,
                      prof: PhaseProfiler = OFF):
    """The one-off hybrid event at s == spsa.start_step: G-1 extra branches
    are sampled, each gets its own SPSA update, then the G-group ensemble
    is scored and pruned like ``atp_prune``.  Branches with index >= 2 use
    zeta = zeta0, not ``zeta`` (the reference implementation's multi-scale
    quirk).  noise: [G-1, B, NL, D]; spsa_noise: [G-1, k, B, NL, 3];
    adjust_fn: the RL adjustment of the branch steps; group: as in
    ``atp_prune`` (each branch's SPSA update is per row and stays
    local); prof: times the ``hyb.*`` phases and the branches' ``spsa.*``
    ones."""
    g_extra = atp_cfg.num_groups - 1
    with prof.phase("hyb.branch"):
        zb, xhb = _branches(core, eps_fn, z_lig, xh_pocket, lig_mask,
                            pocket_mask, s_norm, t_norm, g_extra, noise,
                            generator, noise_scale, adjust_fn)
    updated = [spsa_update(
        core, eps_fn, oracle, zb[i], xhb[i], lig_mask, pocket_mask, t_norm,
        spsa_cfg.zeta0 if i >= 2 else zeta, spsa_cfg,
        noise=None if spsa_noise is None else spsa_noise[i],
        generator=generator, prof=prof) for i in range(g_extra)]
    z_groups = torch.cat([z_lig[None]] + [u[0][None] for u in updated])
    xh_groups = torch.cat([xh_pocket[None]] + [u[1][None] for u in updated])
    with prof.phase("hyb.look"):
        z0 = _lookahead(core, eps_fn, z_groups, xh_groups, lig_mask,
                        pocket_mask, t_norm)
    return _score_and_select(core, oracle, z_groups, xh_groups, z0,
                             lig_mask, pocket_mask, s_step, atp_cfg, group,
                             prof, "hyb")
