"""The host-side reward oracle of guided sampling.

Builds molecules from (coordinates, atom types, mask) batches and scores
them with a weighted reward; one call scores a whole candidate
population.  Reward profiles:

- SPSA: 2*QED + 3*SA + Lipinski/5
- SVDD: 2*QED + 2*SA + sigmoid(k(logp-lo)) * sigmoid(-k(logp-hi))
        + Lipinski/5
- RL (the batch mean): 6*QED + 2*SA + Lipinski/5

Invalid molecules score 0 in every term.  With a receptor set
(``set_receptor``), a nonzero ``w_vina`` adds ``w_vina * (-Vina-style
score)`` (chem/scoring.py); such batches are scored row by row in the
calling process, which alone holds the receptor.  The scorer is an
explicit choice: ``"native"`` (one C++ call per batch, ``chem/native.py``) or
``"python"`` (this package's chem stack); both return the same float32
rewards bit for bit, with any number of workers.

Data-parallel sampling needs nothing here like the JAX oracle's
``result_mesh``.  There the rewards come back from one host callback
pinned to device 0, and ``result_mesh`` replicates them over the mesh.
Here each rank scores its own rows with its own oracle on its host, and
what crosses ranks (ATP's mixed rewards) is all-gathered by the selection
itself (``guidance.atp``).

This module imports torch only where a method takes tensors, so that the
spawned workers of the Python scorer load the chem stack alone.  A
population's scoring is the span ``oracle.score`` on a profiler's
timeline (``utils.profiling.annotate``, which loads no torch).
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import partial
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import numpy as np

from diffndm_tpu_torch.chem import properties as P
from diffndm_tpu_torch.chem.bonds import build_molecule
from diffndm_tpu_torch.chem.sanitize import (SanitizeError,
                                             connectivity_fraction, sanitize)
from diffndm_tpu_torch.utils.profiling import annotate

if TYPE_CHECKING:
    import torch

# a process pool pays for itself from this many Python rows on
_MIN_POOL_ROWS = 8


def _sigmoid(z: float) -> float:
    return 1.0 / (1.0 + math.exp(-z))


def score_row(dataset_info: dict, weights: tuple, item,
              scorer=None) -> Tuple[float, bool]:
    """The Python pipeline for one molecule: item (coords [n, 3], types
    [n]) -> (reward, valid).  weights: the six reward weights, then
    w_vina and w_connectivity; the affinity term needs ``scorer`` (a
    VinaScorer).  Top level, so that a spawned worker can run it."""
    w_qed, w_sa, w_lip, logp_k, logp_lo, logp_hi, w_vina, w_conn = weights
    coords, types = item
    try:
        mol = build_molecule(coords, types, dataset_info)
        sanitize(mol)
    except SanitizeError:
        return 0.0, False
    r = (w_qed * P.qed(mol) + w_sa * P.sa_score(mol)
         + w_lip * P.lipinski_count(mol))
    if logp_k > 0:
        lp = P.logp(mol)
        r += (_sigmoid(logp_k * (lp - logp_lo))
              * _sigmoid(-logp_k * (lp - logp_hi)))
    if w_vina > 0 and scorer is not None:
        r += w_vina * (-scorer.score(mol))
    if w_conn > 0:
        r += w_conn * connectivity_fraction(mol)
    return float(r), True


class RewardOracle:
    def __init__(self, dataset_info: dict, scorer: str = "native",
                 native_sources: Optional[Sequence] = None,
                 num_workers: Optional[int] = None):
        """scorer="native" builds and loads the C++ scorer and raises when
        that fails; rows it flags as not handled (over 60 atoms or 64
        bonds, an element outside its table) are scored by the Python
        pipeline and counted in ``n_python_rows``.  scorer="python" scores
        every row in Python.

        num_workers (default: ``DIFFNDM_ORACLE_WORKERS``, else 0): above
        1, the native scorer splits a batch into that many contiguous
        chunks scored on as many threads (the C++ call releases the
        interpreter lock and keeps no state between calls), and the
        Python rows of a call go to that many spawned processes when
        there are at least 8 of them.  The pools are made at first need
        and released by ``close()``.  Every counter is summed here, in
        the caller, whatever the workers (the JAX package's pool workers
        count into oracles of their own, so its counts miss their rows);
        the rewards are the same bit for bit."""
        if scorer not in ("native", "python"):
            raise ValueError(f"scorer must be 'native' or 'python', got "
                             f"{scorer!r}")
        if num_workers is None:
            num_workers = int(os.environ.get("DIFFNDM_ORACLE_WORKERS", 0))
        self.dataset_info = dataset_info
        self.num_workers = num_workers
        self._threads: Optional[ThreadPoolExecutor] = None
        self._processes: Optional[ProcessPoolExecutor] = None
        self.native = None
        self.scorer = None      # the receptor of the w_vina term
        if scorer == "native":
            from diffndm_tpu_torch.chem.native import SOURCES, NativeScorer

            self.native = NativeScorer(dataset_info,
                                       native_sources or SOURCES)
        self.reset_counts()

    def close(self) -> None:
        """Shut the worker pools down (they are made again if the oracle
        scores once more)."""
        for pool in (self._threads, self._processes):
            if pool is not None:
                pool.shutdown()
        self._threads = self._processes = None

    def __enter__(self) -> "RewardOracle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def set_receptor(self, pdb_path_or_scorer) -> None:
        """Attach the receptor of the affinity term: a PDB path (read with
        ``VinaScorer.from_pdb``) or a VinaScorer."""
        from diffndm_tpu_torch.chem.scoring import VinaScorer

        if isinstance(pdb_path_or_scorer, str):
            self.scorer = VinaScorer.from_pdb(pdb_path_or_scorer)
        else:
            self.scorer = pdb_path_or_scorer

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
    def score_batch_types(self, coords: np.ndarray, types: np.ndarray,
                          mask: np.ndarray, weights: tuple) -> np.ndarray:
        """coords [B, N, 3] Angstrom, types [B, N] atom-type indices, mask
        [B, N]; weights (w_qed, w_sa, w_lipinski, logp_k, logp_lo,
        logp_hi[, w_vina, w_connectivity]), the JAX package's layout ->
        rewards [B] float32.  A nonzero w_vina or w_connectivity bypasses
        the native scorer; a nonzero w_vina also the process pool."""
        t0 = time.perf_counter()
        try:
            with annotate("oracle.score"):
                return self._score_batch(np.asarray(coords),
                                         np.asarray(types),
                                         np.asarray(mask) > 0.5, weights)
        finally:
            self.n_calls += 1
            self.seconds += time.perf_counter() - t0

    def _score_batch(self, coords, types, mask, weights) -> np.ndarray:
        w_vina = weights[6] if len(weights) > 6 else 0.0
        w_conn = weights[7] if len(weights) > 7 else 0.0
        out = np.zeros(coords.shape[0], dtype=np.float32)
        rows = np.arange(coords.shape[0])
        # the native scorer computes the six-weight reward and nothing more
        if self.native is not None and w_vina == 0 and w_conn == 0:
            rewards, handled, terms = self._score_native(coords, types, mask,
                                                         weights[:6])
            self.n_scored += int(handled.sum())
            self.n_invalid += int((handled & (terms[:, 0] == 0)).sum())
            if handled.all():
                return rewards
            out[handled] = rewards[handled]
            rows = np.where(~handled)[0]
            self.n_python_rows += len(rows)
        items = [(coords[b][mask[b]], types[b][mask[b]]) for b in rows]
        score = partial(score_row, self.dataset_info,
                        (*weights[:6], w_vina, w_conn),
                        scorer=self.scorer if w_vina else None)
        # the receptor lives in this process only: an affinity batch is
        # scored here, row by row
        if (self.num_workers > 1 and len(items) >= _MIN_POOL_ROWS
                and w_vina == 0):
            if self._processes is None:
                import multiprocessing

                self._processes = ProcessPoolExecutor(
                    self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"))
            results = list(self._processes.map(score, items, chunksize=4))
        else:
            results = [score(item) for item in items]
        for b, (r, valid) in zip(rows, results):
            out[b] = r
            self.n_invalid += not valid
        self.n_scored += len(results)
        return out

    def _score_native(self, coords, types, mask, weights):
        """``NativeScorer.score`` over num_workers contiguous row chunks on
        threads, or in one call."""
        n = min(self.num_workers, len(coords))
        if n < 2:
            return self.native.score(coords, types, mask, weights)
        if self._threads is None:
            self._threads = ThreadPoolExecutor(self.num_workers)
        parts = [self._threads.submit(self.native.score, coords[c], types[c],
                                      mask[c], weights)
                 for c in (slice(r[0], r[-1] + 1) for r in
                           np.array_split(np.arange(len(coords)), n))]
        return tuple(np.concatenate(r) for r in
                     zip(*(p.result() for p in parts)))

    # -- device side -------------------------------------------------------
    def rewards(self, coords: torch.Tensor, h: torch.Tensor,
                mask: torch.Tensor, weights: tuple) -> torch.Tensor:
        """coords [B, N, 3] Angstrom, h [B, N, F] type scores (one-hot or
        not: the type is their argmax), mask [B, N], on any device ->
        rewards [B] float32 on that device.  One device-to-host copy."""
        import torch

        packed = torch.cat([coords,
                            h.argmax(-1, keepdim=True).to(coords.dtype),
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

    def rl_reward_host(self, coords, h, mask, cfg) -> float:
        """The REINFORCE reward: the batch mean of the RL profile
        (``RLConfig`` weights, no LogP window).  coords [B, N, 3], h
        [B, N, F], mask [B, N], numpy arrays or tensors on any device."""
        import torch

        host = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a) for a in (coords, h, mask)]
        r = self.score_batch_types(host[0], host[1].argmax(-1), host[2], (
            cfg.w_qed, cfg.w_sa, cfg.w_lipinski, 0.0, 0.0, 0.0))
        return float(np.mean(r))
