"""Joint node-count prior p(N_lig, N_pocket): joint and conditional size
sampling and the log-probabilities.  Tables are host-side; sizes are
drawn with a CPU generator."""

from __future__ import annotations

from typing import Optional, Tuple

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

    @property
    def entropy(self) -> float:
        p = self.prob.reshape(-1)
        return float(-(p * torch.log(p + 1e-30)).sum())

    def sample(self, n_samples: int = 1,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(N_lig, N_pocket) pairs [n_samples] each from the joint
        histogram."""
        idx = torch.multinomial(self.prob.reshape(-1), n_samples,
                                replacement=True, generator=generator)
        n2 = self.prob.shape[1]
        return (idx // n2).numpy(), (idx % n2).numpy()

    def sample_conditional(self, n2, generator: Optional[torch.Generator]
                           = None) -> np.ndarray:
        """N_lig ~ p(N_lig | N_pocket = n2) for each entry of n2 [B]."""
        n2 = torch.as_tensor(np.asarray(n2), dtype=torch.long)
        probs = torch.exp(self.log_n1_given_n2.T[n2])      # [B, max_n1]
        return torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()

    def log_prob(self, n1, n2) -> torch.Tensor:
        return self.log_prob_table[_index(n1), _index(n2)]

    def log_prob_n1_given_n2(self, n1, n2) -> torch.Tensor:
        return self.log_n1_given_n2[_index(n1), _index(n2)]

    def log_prob_n2_given_n1(self, n2, n1) -> torch.Tensor:
        return self.log_n2_given_n1[_index(n1), _index(n2)]


def _index(n) -> torch.Tensor:
    return torch.as_tensor(np.asarray(n), dtype=torch.long)


def smoothed_histogram(n_lig, n_pocket, smooth_sigma: float = 1.0
                       ) -> np.ndarray:
    """The joint (ligand size, pocket size) histogram of a dataset,
    Gaussian-smoothed, as the data processing writes it."""
    from scipy.ndimage import gaussian_filter

    idx = np.stack([np.asarray(n_lig), np.asarray(n_pocket)], axis=1)
    hist = np.zeros((idx[:, 0].max() + 1, idx[:, 1].max() + 1))
    for i, j in idx:
        hist[i, j] += 1
    return gaussian_filter(hist, sigma=smooth_sigma)


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
