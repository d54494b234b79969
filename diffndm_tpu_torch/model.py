"""DiffNDM: the model facade of the port.

Builds the denoiser, the noise schedule and the size prior from a model
config, loads weights (exported from the JAX package, or the reference
implementation's checkpoint), prepares pockets from the processed dataset
or from a PDB file and a reference ligand, generates ligands (unguided,
or with the SPSA / ATP guidance the sample config enables, scored by the
chemistry reward oracle; optionally adjusted and trained by the RL
AdjustNet), completes fixed fragments (RePaint inpainting, optionally
guided), diversifies ligands by partial noising and denoising, and turns
the result into filtered molecules.  A joint-mode config (``mode:
'joint'``) also gets ``joint_sampler``, which generates or inpaints ligand
and pocket together; its conditional entry points run the conditional
sampler on the joint-mode denoiser, as the JAX package does.  The
JAX package's model variants build from their configs too: the sinusoid
distance embedding, ``mean`` aggregation, the edge-type embedding, the
GNN denoiser (``EGNNConfig.mode``), ``pocket_conditioning_simple`` and
the learned noise schedule (VLB only), whose gamma network weights travel
beside the denoiser's.

The denoiser's precision and sparsity modes are ``EGNNConfig`` fields:
``compute_dtype`` ("float32", or "bfloat16": the kernels' bf16 variants,
forward and backward), ``neighbors`` (K-nearest-neighbour edges) and
``band_window`` / ``row_tile`` (the sorted band).  Set them with
``dataclasses.replace`` on the config before building the model; the
weights are the same in every mode.  ``enable_banding`` picks the band's
window for a pocket: exact by default, the pocket's halfwidth bound
(``models/banding.band_halfwidth_atoms``) covered on both sides of a row
tile.  ``generate_ligands`` and ``generate_ligands_multi`` do so for each
PDB pocket and print ``[banding] window=...`` unless
``DIFFNDM_AUTO_BAND=0``; ``DIFFNDM_BAND_APPROX=W`` caps the window at W
(rounded up to 16), below the exact bound, which drops real edges and
changes the result.  An exact window drops no edge of the cutoff graph,
whose other pairs the kernels skip anyway, so the facade runs the
denoiser without the band there (no host sort of the pocket per forward)
and keeps the window in its config; a capped window runs the band.

``sample_given_pocket`` and ``result_to_molecules`` are the spans
``facade.sample_given_pocket`` and ``facade.result_to_molecules`` on a
profiler's timeline (``utils.profiling``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffndm_tpu_torch.chem.bonds import build_molecule
from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.chem.sanitize import process_molecule
from diffndm_tpu_torch.config import (EGNNConfig, ModelConfig, SampleConfig,
                                      load_yaml, model_config_from_yaml)
from diffndm_tpu_torch.constants import dataset_params
from diffndm_tpu_torch.convert import (gamma_params_from_jax,
                                       load_reference_checkpoint,
                                       params_from_jax, params_to_jax,
                                       split_trees)
from diffndm_tpu_torch.data.dataset import LigandPocketPair
from diffndm_tpu_torch.data.pdb import parse_pdb
from diffndm_tpu_torch.data.pocket import (get_pocket_from_ligand,
                                           prepare_pocket)
from diffndm_tpu_torch.device import resolve_device
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.diffusion.diversify import (DiversifyNoise,
                                                   DiversifySampler)
from diffndm_tpu_torch.diffusion.inpaint import InpaintNoise, InpaintSampler
from diffndm_tpu_torch.diffusion.joint import JointDiffusion, JointSampler
from diffndm_tpu_torch.diffusion.node_distribution import (DistributionNodes,
                                                           default_histogram)
from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,
                                                 SampleResult, SamplerNoise)
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.models.adjust_net import AdjustNetState
from diffndm_tpu_torch.models.banding import band_halfwidth_atoms
from diffndm_tpu_torch.models.dynamics import EGNNDynamics
from diffndm_tpu_torch.structs import (NodeBatch, concat_batches, pad_to,
                                       to_lists)
from diffndm_tpu_torch.utils.profiling import annotate


class DiffNDM:
    def __init__(self, model_cfg: ModelConfig,
                 sample_cfg: Optional[SampleConfig] = None,
                 size_histogram: Optional[np.ndarray] = None,
                 device=None, scorer: str = "native"):
        """device: ``cuda`` unless given; raises when no GPU is present
        and no device was named.  scorer: the reward oracle's scorer when
        ``sample_cfg`` enables guidance or RL training: "native" (the C++
        scorer, built at first use; raises if it cannot be built) or
        "python"."""
        if model_cfg.mode not in ("pocket_conditioning",
                                  "pocket_conditioning_simple", "joint"):
            raise ValueError(f"unknown model mode {model_cfg.mode!r}")
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.sample_cfg = sample_cfg or SampleConfig()
        self.dataset_info = dataset_params[model_cfg.dataset]
        self.dynamics = EGNNDynamics(model_cfg.egnn, model_cfg.atom_nf,
                                     model_cfg.residue_nf).to(self.device)
        self.dynamics.eval()
        d = model_cfg.diffusion
        if d.noise_schedule == "learned" and d.loss_type != "vlb":
            raise ValueError("a learned noise schedule requires the vlb "
                             "objective")
        schedule = S.make_schedule(d.noise_schedule, d.timesteps,
                                   d.noise_precision, device=self.device)
        # the gamma network of a learned schedule, else None
        self.gamma = getattr(schedule, "network", None)
        if self.gamma is None:
            S.check_norm_values(schedule, d.norm_values[1])
        self.core = CondDiffusion(
            schedule, d, model_cfg.atom_nf, model_cfg.residue_nf,
            simple=model_cfg.mode == "pocket_conditioning_simple")
        self.size_distribution = DistributionNodes(
            size_histogram if size_histogram is not None
            else default_histogram())
        sc = self.sample_cfg
        self.scorer = scorer
        self.oracle = None
        if sc.spsa.enabled or sc.atp.enabled or sc.rl.train:
            self.oracle = RewardOracle(self.dataset_info, scorer=scorer)
        self.sampler = ConditionalSampler(self.core, self.dynamics,
                                          self.sample_cfg, self.oracle)
        self.inpaint_sampler = InpaintSampler(self.core, self.dynamics,
                                              self.sample_cfg, self.oracle)
        self.diversify_sampler = DiversifySampler(self.core, self.dynamics)
        # the joint sampler shares the denoiser, so loaded weights reach it
        self.joint_sampler: Optional[JointSampler] = None
        if model_cfg.mode == "joint":
            self.joint_sampler = JointSampler(
                JointDiffusion(schedule, d, model_cfg.atom_nf,
                               model_cfg.residue_nf), self.dynamics)
        self.adjust_state: Optional[AdjustNetState] = None

    @classmethod
    def from_yaml(cls, path: str, **kw) -> "DiffNDM":
        return cls(model_config_from_yaml(load_yaml(path)), **kw)

    def load_params_npz(self, path: str) -> None:
        """Load a JAX parameter tree saved as a flat npz ('/'-joined keys,
        e.g. ``assets/virtual_cond_v3b_ema.npz``).  With a learned
        schedule the file holds the trees ``dynamics/...`` and
        ``gamma/...`` (as ``save_params_npz`` writes them)."""
        with np.load(path) as f:
            tree = {k: f[k] for k in f.files}
        dyn, gamma = split_trees(tree)
        if (gamma is None) != (self.gamma is None):
            raise ValueError(f"{path}: a gamma tree goes with a learned "
                             f"noise schedule, and only with one")
        self.set_params(params_from_jax(dyn), None if gamma is None
                        else gamma_params_from_jax(gamma))

    def set_params(self, state: Dict[str, torch.Tensor],
                   gamma_state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> None:
        """Copy a state_dict of the denoiser (the trainer's EMA weights,
        say) into the model's own parameters; ``gamma_state``: that of a
        learned schedule's gamma network, if given."""
        self.dynamics.load_state_dict(state, strict=True)
        if gamma_state is not None:
            self.gamma.load_state_dict(gamma_state, strict=True)

    def save_params_npz(self, path: str) -> None:
        """The denoiser's weights (and a learned schedule's) as the flat
        JAX tree that ``load_params_npz`` reads."""
        out = params_to_jax(self.dynamics.state_dict())
        if self.gamma is not None:
            out = {f"dynamics/{k}": v for k, v in out.items()}
            out.update({f"gamma/{k}": v for k, v in params_to_jax(
                self.gamma.state_dict()).items()})
        np.savez(path, **out)

    def load_reference_checkpoint(self, path: str) -> None:
        """Load the reference implementation's Lightning ``.ckpt`` (or a
        raw state dict of it); see ``convert.load_reference_checkpoint``."""
        self.dynamics.load_state_dict(
            load_reference_checkpoint(path, self.cfg), strict=True)

    def ensure_oracle(self) -> RewardOracle:
        """The reward oracle, built at first use with the model's scorer
        and handed to the samplers."""
        if self.oracle is None:
            self.oracle = RewardOracle(self.dataset_info, scorer=self.scorer)
            self.sampler.oracle = self.inpaint_sampler.oracle = self.oracle
        return self.oracle

    def close(self) -> None:
        """Release the reward oracle's worker pools, if it has any
        (``DIFFNDM_ORACLE_WORKERS``); the model stays usable."""
        if self.oracle is not None:
            self.oracle.close()

    def __enter__(self) -> "DiffNDM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def set_egnn_config(self, egnn: EGNNConfig,
                        band_exact: bool = False) -> None:
        """Switch the denoiser to another EGNN config of the same widths
        (a mode or a band window): the parameters are the same in every
        mode, so the modules keep their weights and the samplers, which
        share the denoiser, follow.

        band_exact: the window drops no pair of the cutoff graph, whose
        other pairs the kernels skip already.  The model's config keeps
        the window and the modules run without the band, which would cost
        a host sort of the pocket per forward and change nothing."""
        self.cfg = dataclasses.replace(self.cfg, egnn=egnn)
        run = (dataclasses.replace(egnn, band_window=None) if band_exact
               else egnn)
        for module in self.dynamics.modules():
            if isinstance(getattr(module, "cfg", None), EGNNConfig):
                module.cfg = run

    def _band_cutoff(self) -> float:
        eg = self.cfg.egnn
        return max(eg.edge_cutoff_pocket or 0.0,
                   eg.edge_cutoff_interaction or 0.0)

    def enable_banding(self, pocket: NodeBatch, margin: int = 16,
                       row_tile: int = 8) -> int:
        """Turn the sorted band on with a window chosen for this pocket
        (the JAX package's rule): 2 * halfwidth + tile + margin, rounded
        up to 16, so that (window - tile) / 2 covers
        ``band_halfwidth_atoms`` and the band drops only pairs beyond the
        cutoffs; ``DIFFNDM_BAND_APPROX=W`` caps it at W rounded up to 16.
        Returns the window, or 0 (band off) where the window would span
        the whole pocket, with neighbour lists, or without a cutoff.  The
        denoiser runs the band only where the cap takes the window below
        the bound (``set_egnn_config``'s ``band_exact``)."""
        eg = self.cfg.egnn
        cutoff = self._band_cutoff()
        if cutoff <= 0 or eg.neighbors is not None:
            return 0
        hw = band_halfwidth_atoms(pocket.x.cpu().numpy(),
                                  pocket.mask.cpu().numpy(), cutoff)
        tile = min(row_tile or eg.row_tile, eg.row_tile)
        w = -(-(2 * hw + tile + margin) // 16) * 16
        approx = int(os.environ.get("DIFFNDM_BAND_APPROX") or 0)
        if approx > 0:
            w = min(w, -(-approx // 16) * 16)
        if w >= pocket.x.shape[1]:
            if eg.band_window is not None:
                # a window chosen for another pocket must not stay on
                self.set_egnn_config(dataclasses.replace(eg,
                                                         band_window=None))
            return 0
        self.set_egnn_config(dataclasses.replace(eg, band_window=w,
                                                 row_tile=tile),
                             band_exact=w >= 2 * hw + tile)
        return w

    def ensure_band_for(self, pocket: NodeBatch) -> int:
        """Keep the current window where it covers this pocket's bound,
        widen it where it does not, pick one where the band is off.
        Returns the window in force (0: dense)."""
        eg = self.cfg.egnn
        if eg.band_window is None:
            return self.enable_banding(pocket)
        hw = band_halfwidth_atoms(pocket.x.cpu().numpy(),
                                  pocket.mask.cpu().numpy(),
                                  self._band_cutoff())
        needed = 2 * hw + eg.row_tile
        if eg.band_window >= needed:
            self.set_egnn_config(eg, band_exact=True)
            return eg.band_window
        if needed >= pocket.x.shape[1]:
            self.set_egnn_config(dataclasses.replace(eg, band_window=None))
            return 0
        return self.enable_banding(pocket, row_tile=eg.row_tile)

    def _auto_band(self, pocket: NodeBatch) -> int:
        """The band for a PDB pocket unless ``DIFFNDM_AUTO_BAND=0``."""
        if os.environ.get("DIFFNDM_AUTO_BAND", "1") == "0":
            return 0
        return self.ensure_band_for(pocket)

    def ensure_adjust(self) -> AdjustNetState:
        """The AdjustNet, made at first use (input width 3 + atom_nf, the
        rest of ``sample_cfg.rl``, seed 0) on the model's device."""
        if self.adjust_state is None:
            self.adjust_state = AdjustNetState(
                dataclasses.replace(self.sample_cfg.rl,
                                    input_dim=3 + self.cfg.atom_nf),
                device=self.device)
        return self.adjust_state

    def pocket_from_dataset(self, pair: LigandPocketPair,
                            n_samples: int) -> NodeBatch:
        """A pocket of the processed dataset repeated n_samples times,
        padded to ``pocket_pad_multiple``; the padding type columns of the
        one-hot encoding are dropped to the model's residue_nf."""
        npk = len(pair.pocket_coords)
        npad = pad_to(npk, self.sample_cfg.pocket_pad_multiple)
        nf = self.cfg.residue_nf
        x = np.zeros((n_samples, npad, 3), np.float32)
        h = np.zeros((n_samples, npad, nf), np.float32)
        mask = np.zeros((n_samples, npad), np.float32)
        x[:, :npk] = pair.pocket_coords
        h[:, :npk] = pair.pocket_one_hot[:, :nf]
        mask[:, :npk] = 1.0
        return NodeBatch(torch.from_numpy(x), torch.from_numpy(h),
                         torch.from_numpy(mask)).to(self.device)

    def pocket_from_pdb(self, pdb_file: str, ref_ligand: str,
                        n_samples: int, dist_cutoff: float = 8.0
                        ) -> NodeBatch:
        """The pocket around ``ref_ligand`` (an SDF path or
        ``<chain>:<resi>``) in a PDB file, repeated n_samples times and
        padded to ``pocket_pad_multiple``; encoder types beyond the
        model's residue_nf (the padding types) are dropped."""
        residues = get_pocket_from_ligand(parse_pdb(pdb_file), ref_ligand,
                                          dist_cutoff)
        encoder = (self.dataset_info["aa_encoder"]
                   if self.cfg.pocket_representation == "CA"
                   else self.dataset_info["atom_encoder"])
        enc = {k: v for k, v in encoder.items() if v < self.cfg.residue_nf}
        return prepare_pocket(residues, enc, self.cfg.pocket_representation,
                              repeats=n_samples,
                              pad_multiple=self.sample_cfg.pocket_pad_multiple,
                              device=self.device)

    def sample_ligand_sizes(self, pocket: NodeBatch,
                            generator: Optional[torch.Generator] = None
                            ) -> np.ndarray:
        """N_lig ~ p(N_lig | N_pocket), at least 2.  The size tables live
        on the host, so ``generator`` is a CPU generator."""
        n_pocket = pocket.size.cpu().numpy().astype(int)
        n_pocket = np.clip(n_pocket, 0,
                           self.size_distribution.prob.shape[1] - 1)
        sizes = self.size_distribution.sample_conditional(n_pocket,
                                                          generator)
        return np.maximum(sizes, 2)

    def sample_given_pocket(self, pocket: NodeBatch, num_nodes_lig,
                            timesteps: Optional[int] = None,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[SamplerNoise] = None,
                            optimize: bool = False,
                            collect_rl: bool = False) -> SampleResult:
        """Generation for a padded pocket batch, guided as ``sample_cfg``
        says; with ``optimize`` the AdjustNet (``ensure_adjust``) adjusts
        every step.  See ``ConditionalSampler.sample_given_pocket``."""
        with annotate("facade.sample_given_pocket"):
            adjust = self.ensure_adjust().module if optimize else None
            return self.sampler.sample_given_pocket(
                pocket.to(self.device), num_nodes_lig, timesteps=timesteps,
                generator=generator, noise=noise, adjust=adjust,
                collect_rl=collect_rl)

    def _generate(self, pocket: NodeBatch, seed: int, num_nodes_lig,
                  optimize: bool, collect_rl: bool) -> SampleResult:
        """Sizes from the prior (a CPU generator) unless given, then the
        sampler (a generator on the model's device), both seeded; the
        step count is ``sample_cfg.timesteps``."""
        if num_nodes_lig is None:
            num_nodes_lig = self.sample_ligand_sizes(
                pocket, torch.Generator().manual_seed(seed))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.sample_given_pocket(pocket, num_nodes_lig,
                                        generator=generator,
                                        optimize=optimize,
                                        collect_rl=collect_rl)

    def inpaint(self, ligand: NodeBatch, lig_fixed: torch.Tensor,
                pocket: NodeBatch, seed: int = 0,
                timesteps: Optional[int] = None,
                resamplings: Optional[int] = None, svdd: bool = False,
                spsa: Optional[bool] = None, center: Optional[str] = None,
                noise: Optional[InpaintNoise] = None) -> SampleResult:
        """RePaint completion of the fixed atoms ``lig_fixed`` [B, NL] of
        ``ligand`` in ``pocket``, ATP-guided with ``svdd`` and
        SPSA-guided with ``spsa`` (default ``sample_cfg.spsa.enabled``),
        the oracle built at first need; a generator on the model's device
        seeded with ``seed``.  See ``InpaintSampler.inpaint``."""
        if svdd or (self.sample_cfg.spsa.enabled if spsa is None else spsa):
            self.ensure_oracle()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.inpaint_sampler.inpaint(
            ligand.to(self.device), lig_fixed.to(self.device),
            pocket.to(self.device), timesteps=timesteps,
            resamplings=resamplings, svdd=svdd, spsa=spsa, center=center,
            generator=generator, noise=noise)

    def diversify(self, ligand: NodeBatch, pocket: NodeBatch,
                  noising_steps: int, seed: int = 0,
                  noise: Optional[DiversifyNoise] = None) -> SampleResult:
        """Partial noise-then-denoise of each ligand over noising_steps
        steps, the noise from a generator on the model's device seeded
        with ``seed``.  See ``DiversifySampler.diversify``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.diversify_sampler.diversify(
            ligand.to(self.device), pocket.to(self.device), noising_steps,
            generator=generator, noise=noise)

    def generate_ligands(self, pdb_file: str, ref_ligand: str,
                         seed: int = 0,
                         num_nodes_lig: Optional[np.ndarray] = None
                         ) -> Tuple[List[Optional[Molecule]], SampleResult]:
        """End-to-end generation for one pocket of a PDB file, as
        ``sample_cfg`` sets it: ``n_samples`` ligands in ``timesteps``
        steps, adjusted by the AdjustNet when ``rl.enabled``; with
        ``rl.train`` the trajectory is kept and one REINFORCE update
        follows (its numbers in ``adjust_state.history``).  Returns the
        filtered molecules (None where a filter failed) and the result."""
        sc = self.sample_cfg
        pocket = self.pocket_from_pdb(pdb_file, ref_ligand, sc.n_samples)
        w = self._auto_band(pocket)
        if w:
            print(f"[banding] window={w} pocket atoms="
                  f"{int(pocket.mask.sum(1).max())}")
        if sc.rl.train:
            self.ensure_adjust()
        result = self._generate(pocket, seed, num_nodes_lig, sc.rl.enabled,
                                sc.rl.train)
        if sc.rl.train:
            self.sampler.rl_update(self.adjust_state, result)
        return self.result_to_molecules(result), result

    def generate_ligands_multi(self, pdb_refs: Sequence[Tuple[str, str]],
                               seed: int = 0
                               ) -> Dict[str, List[Optional[Molecule]]]:
        """Many (PDB file, reference ligand) pockets in one batch of
        n_pockets * ``sample_cfg.n_samples`` rows, pockets padded to a
        common size, no AdjustNet.  Returns {PDB file name: molecules}.
        With ATP, ``ATPConfig.group_size`` must be n_samples, so that a
        prune selects within each pocket's rows."""
        n_samples = self.sample_cfg.n_samples
        atp = self.sample_cfg.atp
        if atp.enabled and len(pdb_refs) > 1 and not atp.per_sample and \
                atp.group_size != n_samples:
            raise ValueError(f"ATP over several pockets needs "
                             f"ATPConfig(group_size={n_samples})")
        pockets = [self.pocket_from_pdb(pdb_file, ref, n_samples)
                   for pdb_file, ref in pdb_refs]
        pocket = concat_batches(pockets)
        # each row is sorted on its own; the window covers the widest
        # pocket's bound
        self._auto_band(pocket)
        result = self._generate(pocket, seed, None, False, False)
        mols = self.result_to_molecules(result)
        return {os.path.basename(pdb_file): mols[i * n_samples:
                                                 (i + 1) * n_samples]
                for i, (pdb_file, _) in enumerate(pdb_refs)}

    def result_to_molecules(self, result: SampleResult
                            ) -> List[Optional[Molecule]]:
        """Bond perception, then the filters of ``process_molecule`` as
        ``sample_cfg`` sets them (``sanitize``, ``largest_frag``,
        ``relax_iter``): None where one fails; with no filter, every
        molecule."""
        sc = self.sample_cfg
        with annotate("facade.result_to_molecules"):
            return [process_molecule(build_molecule(coords, types,
                                                    self.dataset_info),
                                     sanitize_flag=sc.sanitize,
                                     relax_iter=sc.relax_iter,
                                     largest_frag=sc.largest_frag)
                    for coords, types in to_lists(result.ligand)]
