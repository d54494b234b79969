"""Joint node-count prior p(N_lig, N_pocket) and conditional size
sampling.  Tables are host-side; sizes are drawn with a CPU generator."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DistributionNodes:
    def __init__(self, histogram: np.ndarray):
        histogram = np.asarray(histogram, dtype=np.float64) + 1e-3
        p = (histogram / histogram.sum()).astype(np.float32)
        self.prob = torch.from_numpy(p)
        self.log_prob_table = torch.log(self.prob)
        # conditionals, normalised along each axis
        self.log_n1_given_n2 = torch.from_numpy(
            np.log(p / p.sum(axis=0, keepdims=True)).astype(np.float32))
        self.log_n2_given_n1 = torch.from_numpy(
            np.log(p / p.sum(axis=1, keepdims=True)).astype(np.float32))

    def sample_conditional(self, n2, generator: Optional[torch.Generator]
                           = None) -> np.ndarray:
        """N_lig ~ p(N_lig | N_pocket = n2) for each entry of n2 [B]."""
        n2 = torch.as_tensor(np.asarray(n2), dtype=torch.long)
        probs = torch.exp(self.log_n1_given_n2.T[n2])      # [B, max_n1]
        return torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()


def default_histogram(max_lig: int = 48, max_pocket: int = 600) -> np.ndarray:
    """A synthetic joint size histogram for when no processed dataset is
    at hand: ligand sizes ~N(24, 8), pocket sizes ~N(350, 120), mildly
    correlated."""
    li = np.arange(max_lig + 1)[:, None]
    pi = np.arange(max_pocket + 1)[None, :]
    mu_l = 24.0 + 0.01 * (pi - 350.0)
    hist = np.exp(-0.5 * ((li - mu_l) / 8.0) ** 2
                  - 0.5 * ((pi - 350.0) / 120.0) ** 2)
    hist[:6, :] = 0  # no tiny ligands
    return hist
