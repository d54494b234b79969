"""Eval-time chemistry dashboard: at every eval epoch, ligands sampled
for validation pockets with the current (EMA) weights, scored for the
atom-type KL against the training histogram, validity, connectivity,
uniqueness, novelty, QED, SA, LogP, Lipinski and diversity, and with a
receptor the mean Vina-style affinity of the valid molecules; the valid
molecules optionally written as SDF and, when ``n_visualize`` > 0,
rendered to PNG beside it (``utils/visualization.py``).  Rendering is
best effort, as in the JAX package's dashboard: without matplotlib it
prints why and the SDF stays written."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from diffndm_tpu_torch.chem.bonds import build_molecules_batch
from diffndm_tpu_torch.chem.metrics import (BasicMolecularMetrics,
                                            CategoricalDistribution,
                                            MoleculeProperties)
from diffndm_tpu_torch.structs import NodeBatch


class ChemistryDashboard:
    def __init__(self, dataset_info: dict, outdir: str,
                 train_smiles: Optional[Sequence[str]] = None,
                 n_visualize: int = 0, receptor_pdb: Optional[str] = None):
        self.dataset_info = dataset_info
        self.outdir = outdir
        self.n_visualize = n_visualize
        self.props = MoleculeProperties()
        self.metrics = BasicMolecularMetrics(dataset_info, train_smiles)
        hist = dataset_info.get("atom_hist")
        self.type_dist = (CategoricalDistribution(
            hist, dataset_info["atom_encoder"]) if hist else None)
        self.scorer = None
        if receptor_pdb:
            from diffndm_tpu_torch.chem.scoring import VinaScorer

            self.scorer = VinaScorer.from_pdb(receptor_pdb)

    def analyze(self, ligand: NodeBatch, epoch: int = 0,
                dump_sdf: bool = False) -> dict:
        """A decoded ligand batch -> the dashboard's metrics."""
        coords = ligand.x.detach().cpu().numpy()
        types = ligand.h.detach().cpu().numpy().argmax(-1)
        mask = ligand.mask.detach().cpu().numpy()
        out = {}
        if self.type_dist is not None:
            out["kl_div_atom_types"] = self.type_dist.kl_divergence(
                types[mask > 0.5].tolist())
        mols = build_molecules_batch(coords, types, mask, self.dataset_info)
        (validity, connectivity, uniqueness,
         novelty), (valid, connected) = self.metrics.evaluate_rdmols(mols)
        out.update(Validity=validity, Connectivity=connectivity,
                   Uniqueness=uniqueness, Novelty=novelty)
        qed, sa, logp, lipinski, diversity = self.props.evaluate_mean(
            connected if connected else valid)
        out.update(QED=qed, SA=sa, LogP=logp, Lipinski=lipinski,
                   Diversity=diversity)
        if self.scorer is not None and valid:
            out["VinaAffinity"] = float(np.mean(
                [self.scorer.score(m) for m in valid]))
        if dump_sdf and valid:
            from diffndm_tpu_torch.chem.io import write_sdf

            os.makedirs(self.outdir, exist_ok=True)
            sdf = os.path.join(self.outdir, f"eval_ep{epoch}.sdf")
            write_sdf(sdf, valid)
            if self.n_visualize > 0:
                try:
                    from diffndm_tpu_torch.utils.visualization import \
                        visualize_molecules

                    visualize_molecules(
                        sdf, os.path.join(self.outdir, f"viz_ep{epoch}"))
                except Exception as e:  # rendering is best-effort
                    print(f"[dashboard] visualization failed: {e}")
        return out

    def sample_and_analyze(self, model, pocket: NodeBatch, epoch: int = 0,
                           dump_sdf: bool = False, seed: int = 0) -> dict:
        """Ligands for the (padded) pockets from ``model``'s current
        weights (a ``DiffNDM``): sizes from its size prior (at least 2),
        the sampler seeded with ``seed``; then ``analyze``."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            sizes = model.sample_ligand_sizes(pocket, gen)
            result = model.sample_given_pocket(
                pocket, sizes, generator=torch.Generator(
                    device=model.device).manual_seed(seed))
        return self.analyze(result.ligand, epoch=epoch, dump_sdf=dump_sdf)
