"""DiffNDM: the model facade of the port.

Builds the denoiser, the noise schedule and the size prior from a model
config, loads weights exported from the JAX package, generates ligands
for a pocket (unguided, or with the SPSA / ATP guidance the sample config
enables, scored by the chemistry reward oracle) and turns the result into
molecules.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from diffndm_tpu_torch.chem.bonds import build_molecule
from diffndm_tpu_torch.chem.mol import Molecule
from diffndm_tpu_torch.config import (ModelConfig, SampleConfig, load_yaml,
                                      model_config_from_yaml)
from diffndm_tpu_torch.constants import dataset_params
from diffndm_tpu_torch.convert import params_from_jax
from diffndm_tpu_torch.data.dataset import LigandPocketPair
from diffndm_tpu_torch.device import resolve_device
from diffndm_tpu_torch.diffusion import schedules as S
from diffndm_tpu_torch.diffusion.core import CondDiffusion
from diffndm_tpu_torch.diffusion.node_distribution import (DistributionNodes,
                                                           default_histogram)
from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,
                                                 SampleResult, SamplerNoise)
from diffndm_tpu_torch.guidance.oracle import RewardOracle
from diffndm_tpu_torch.models.dynamics import EGNNDynamics
from diffndm_tpu_torch.structs import NodeBatch, pad_to, to_lists


class DiffNDM:
    def __init__(self, model_cfg: ModelConfig,
                 sample_cfg: Optional[SampleConfig] = None,
                 size_histogram: Optional[np.ndarray] = None,
                 device=None, scorer: str = "native"):
        """device: ``cuda`` unless given; raises when no GPU is present
        and no device was named.  scorer: the reward oracle's scorer when
        ``sample_cfg`` enables guidance: "native" (the C++ scorer, built
        at first use; raises if it cannot be built) or "python"."""
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
        self.oracle = None
        if self.sample_cfg.spsa.enabled or self.sample_cfg.atp.enabled:
            self.oracle = RewardOracle(self.dataset_info, scorer=scorer)
        self.sampler = ConditionalSampler(self.core, self.dynamics,
                                          self.sample_cfg, self.oracle)

    @classmethod
    def from_yaml(cls, path: str, **kw) -> "DiffNDM":
        return cls(model_config_from_yaml(load_yaml(path)), **kw)

    def load_params_npz(self, path: str) -> None:
        """Load a JAX parameter tree saved as a flat npz ('/'-joined keys,
        e.g. ``assets/virtual_cond_v3b_ema.npz``)."""
        with np.load(path) as f:
            tree = {k: f[k] for k in f.files}
        self.dynamics.load_state_dict(params_from_jax(tree), strict=True)

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
                            noise: Optional[SamplerNoise] = None
                            ) -> SampleResult:
        """Generation for a padded pocket batch, guided as ``sample_cfg``
        says; see ``ConditionalSampler.sample_given_pocket``."""
        return self.sampler.sample_given_pocket(
            pocket.to(self.device), num_nodes_lig, timesteps=timesteps,
            generator=generator, noise=noise)

    def result_to_molecules(self, result: SampleResult) -> List[Molecule]:
        return [build_molecule(coords, types, self.dataset_info)
                for coords, types in to_lists(result.ligand)]
