"""DiffNDM: the model facade of the port.

Builds the denoiser, the noise schedule and the size prior from a model
config, loads weights (exported from the JAX package, or the reference
implementation's checkpoint), prepares pockets from the processed dataset
or from a PDB file and a reference ligand, generates ligands (unguided,
or with the SPSA / ATP guidance the sample config enables, scored by the
chemistry reward oracle; optionally adjusted and trained by the RL
AdjustNet) and turns the result into filtered molecules.

The JAX package picks a sorted-band column window per PDB pocket
(``DIFFNDM_AUTO_BAND``).  The window provably drops only pairs beyond the
edge cutoffs, and the port's kernels compute only the real edges of the
cutoff graph anyway, so it is not ported.
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
from diffndm_tpu_torch.config import (ModelConfig, SampleConfig, load_yaml,
                                      model_config_from_yaml)
from diffndm_tpu_torch.constants import dataset_params
from diffndm_tpu_torch.convert import (load_reference_checkpoint,
                                       params_from_jax)
from diffndm_tpu_torch.data.dataset import LigandPocketPair
from diffndm_tpu_torch.data.pdb import parse_pdb
from diffndm_tpu_torch.data.pocket import (get_pocket_from_ligand,
                                           prepare_pocket)
from diffndm_tpu_torch.device import resolve_device
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.diffusion.node_distribution import (DistributionNodes,
                                                           default_histogram)
from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,
                                                 SampleResult, SamplerNoise)
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.models.adjust_net import AdjustNetState
from diffndm_tpu_torch.models.dynamics import EGNNDynamics
from diffndm_tpu_torch.structs import (NodeBatch, concat_batches, pad_to,
                                       to_lists)


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
        if model_cfg.mode != "pocket_conditioning":
            raise NotImplementedError(
                f"mode {model_cfg.mode!r}: the port runs the "
                "pocket-conditional model only")
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.sample_cfg = sample_cfg or SampleConfig()
        self.dataset_info = dataset_params[model_cfg.dataset]
        self.dynamics = EGNNDynamics(model_cfg.egnn, model_cfg.atom_nf,
                                     model_cfg.residue_nf).to(self.device)
        self.dynamics.eval()
        d = model_cfg.diffusion
        schedule = S.make_schedule(d.noise_schedule, d.timesteps,
                                   d.noise_precision, device=self.device)
        S.check_norm_values(schedule, d.norm_values[1])
        self.core = CondDiffusion(schedule, d, model_cfg.atom_nf,
                                  model_cfg.residue_nf)
        self.size_distribution = DistributionNodes(
            size_histogram if size_histogram is not None
            else default_histogram())
        sc = self.sample_cfg
        self.oracle = None
        if sc.spsa.enabled or sc.atp.enabled or sc.rl.train:
            self.oracle = RewardOracle(self.dataset_info, scorer=scorer)
        self.sampler = ConditionalSampler(self.core, self.dynamics,
                                          self.sample_cfg, self.oracle)
        self.adjust_state: Optional[AdjustNetState] = None

    @classmethod
    def from_yaml(cls, path: str, **kw) -> "DiffNDM":
        return cls(model_config_from_yaml(load_yaml(path)), **kw)

    def load_params_npz(self, path: str) -> None:
        """Load a JAX parameter tree saved as a flat npz ('/'-joined keys,
        e.g. ``assets/virtual_cond_v3b_ema.npz``)."""
        with np.load(path) as f:
            tree = {k: f[k] for k in f.files}
        self.dynamics.load_state_dict(params_from_jax(tree), strict=True)

    def load_reference_checkpoint(self, path: str) -> None:
        """Load the reference implementation's Lightning ``.ckpt`` (or a
        raw state dict of it); see ``convert.load_reference_checkpoint``."""
        self.dynamics.load_state_dict(
            load_reference_checkpoint(path, self.cfg), strict=True)

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
        result = self._generate(concat_batches(pockets), seed, None, False,
                                False)
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
        return [process_molecule(build_molecule(coords, types,
                                                self.dataset_info),
                                 sanitize_flag=sc.sanitize,
                                 relax_iter=sc.relax_iter,
                                 largest_frag=sc.largest_frag)
                for coords, types in to_lists(result.ligand)]
