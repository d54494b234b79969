"""The host-side reward oracle of guided sampling.

Builds molecules from (coordinates, atom types, mask) batches and scores
them with a weighted reward; one call scores a whole candidate
population.  Reward profiles:

- SPSA: 2*QED + 3*SA + Lipinski/5
- SVDD: 2*QED + 2*SA + sigmoid(k(logp-lo)) * sigmoid(-k(logp-hi))
        + Lipinski/5

Invalid molecules score 0 in every term.  The scorer is an explicit
choice: ``"native"`` (one C++ call per batch, ``chem/native.py``) or
``"python"`` (this package's chem stack); both return the same float32
rewards bit for bit.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from diffndm_tpu_torch.chem.bonds import build_molecule
from diffndm_tpu_torch.chem.metrics import MoleculeProperties
from diffndm_tpu_torch.chem.sanitize import (SanitizeError,
                                             connectivity_fraction, sanitize)


def _sigmoid(z: float) -> float:
    return 1.0 / (1.0 + math.exp(-z))


class RewardOracle:
    def __init__(self, dataset_info: dict, scorer: str = "native",
                 native_sources: Optional[Sequence] = None):
        """scorer="native" builds and loads the C++ scorer and raises when
        that fails; rows it flags as not handled (over 60 atoms or 64
        bonds, an element outside its table) are scored by the Python
        pipeline and counted in ``n_python_rows``.  scorer="python" scores
        every row in Python."""
        if scorer not in ("native", "python"):
            raise ValueError(f"scorer must be 'native' or 'python', got "
                             f"{scorer!r}")
        self.dataset_info = dataset_info
        self.props = MoleculeProperties()
        self.native = None
        if scorer == "native":
            from diffndm_tpu_torch.chem.native import SOURCES, NativeScorer

            self.native = NativeScorer(dataset_info,
                                       native_sources or SOURCES)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.n_scored = 0       # molecules scored
        self.n_invalid = 0      # of those, failed sanitization (reward 0)
        self.n_python_rows = 0  # rows the native scorer handed to Python
        self.n_calls = 0        # populations scored
        self.seconds = 0.0      # host time spent scoring

    @property
    def invalid_rate(self) -> float:
        return self.n_invalid / max(self.n_scored, 1)

    # -- host side ---------------------------------------------------------
    def _score_one(self, coords, types, w_qed, w_sa, w_lip, logp_k,
                   logp_lo, logp_hi, w_conn=0.0) -> float:
        self.n_scored += 1
        try:
            mol = build_molecule(coords, types, self.dataset_info)
            sanitize(mol)
        except SanitizeError:
            self.n_invalid += 1
            return 0.0
        r = (w_qed * self.props.calculate_qed(mol)
             + w_sa * self.props.calculate_sa(mol)
             + w_lip * self.props.calculate_lipinski(mol))
        if logp_k > 0:
            lp = self.props.calculate_logp(mol)
            r += (_sigmoid(logp_k * (lp - logp_lo))
                  * _sigmoid(-logp_k * (lp - logp_hi)))
        if w_conn > 0:
            r += w_conn * connectivity_fraction(mol)
        return float(r)

    def score_batch_types(self, coords: np.ndarray, types: np.ndarray,
                          mask: np.ndarray, weights: tuple) -> np.ndarray:
        """coords [B, N, 3] Angstrom, types [B, N] atom-type indices, mask
        [B, N]; weights (w_qed, w_sa, w_lipinski, logp_k, logp_lo,
        logp_hi[, w_vina, w_connectivity]), the JAX package's layout, in
        which w_vina must be 0 here -> rewards [B] float32."""
        t0 = time.perf_counter()
        try:
            return self._score_batch(np.asarray(coords), np.asarray(types),
                                     np.asarray(mask) > 0.5, weights)
        finally:
            self.n_calls += 1
            self.seconds += time.perf_counter() - t0

    def _score_batch(self, coords, types, mask, weights) -> np.ndarray:
        if len(weights) > 6 and weights[6] != 0:
            raise NotImplementedError("w_vina needs the docking scorer, "
                                      "which this package does not have")
        w_conn = weights[7] if len(weights) > 7 else 0.0
        out = np.zeros(coords.shape[0], dtype=np.float32)
        rows = range(coords.shape[0])
        # the native scorer computes the six-weight reward and nothing more
        if self.native is not None and w_conn == 0:
            rewards, handled, terms = self.native.score(coords, types, mask,
                                                        weights[:6])
            self.n_scored += int(handled.sum())
            self.n_invalid += int((handled & (terms[:, 0] == 0)).sum())
            if handled.all():
                return rewards
            out[handled] = rewards[handled]
            rows = np.where(~handled)[0]
            self.n_python_rows += len(rows)
        for b in rows:
            out[b] = self._score_one(coords[b][mask[b]], types[b][mask[b]],
                                     *weights[:6], w_conn=w_conn)
        return out

    # -- device side -------------------------------------------------------
    def rewards(self, coords: torch.Tensor, h: torch.Tensor,
                mask: torch.Tensor, weights: tuple) -> torch.Tensor:
        """coords [B, N, 3] Angstrom, h [B, N, F] type scores (one-hot or
        not: the type is their argmax), mask [B, N], on any device ->
        rewards [B] float32 on that device.  One device-to-host copy."""
        packed = torch.cat([coords, h.argmax(-1, keepdim=True).to(coords.dtype),
                            mask[..., None].to(coords.dtype)], -1)
        host = packed.detach().cpu().numpy()
        r = self.score_batch_types(host[..., :3],
                                   host[..., 3].astype(np.int64),
                                   host[..., 4], weights)
        return torch.from_numpy(r).to(coords.device)

    def spsa_rewards(self, coords, h, mask, cfg) -> torch.Tensor:
        return self.rewards(coords, h, mask, (
            cfg.w_qed, cfg.w_sa, cfg.w_lipinski, 0.0, 0.0, 0.0, cfg.w_vina,
            cfg.w_connectivity))

    def svdd_rewards(self, coords, h, mask, cfg) -> torch.Tensor:
        return self.rewards(coords, h, mask, (
            cfg.w_qed, cfg.w_sa, cfg.w_lipinski, cfg.logp_k, cfg.logp_lo,
            cfg.logp_hi, cfg.w_vina, cfg.w_connectivity))
