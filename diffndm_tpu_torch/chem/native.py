"""The native reward scorer: one C++ call per candidate population.

``native/chemscore.cpp`` (``cs_score_batch``) perceives bonds, sanitizes
and computes the weighted QED/SA/LogP/Lipinski reward of every row of a
padded batch, bit-identical to the Python pipeline
(tests/test_torch_oracle.py).  The sources under ``native/`` are read in
place and compiled at first use by the host ``g++`` into a shared library
under ``build/`` at the repository root, cached by a hash of the sources
and flags, and loaded with ctypes.  Nothing is written under ``native/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from diffndm_tpu_torch.chem.properties import load_fpscores

ROOT = Path(__file__).resolve().parents[2]
SOURCES = (ROOT / "native" / "chemgraph.cpp", ROOT / "native" / "chemscore.cpp")
BUILD_DIR = ROOT / "build"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")

# element-code ABI shared with native/chemscore.cpp (enum Elem); any other
# symbol is code 10 and is not scored natively
_ELEM_CODES = {"C": 0, "N": 1, "O": 2, "S": 3, "B": 4, "Br": 5, "Cl": 6,
               "P": 7, "I": 8, "F": 9}


def library_path(sources: Sequence[Path] = SOURCES) -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    return BUILD_DIR / f"chemscore-{digest.hexdigest()[:16]}.so"


def build_library(sources: Sequence[Path] = SOURCES) -> Path:
    """Compile the scorer unless this build of these sources exists.
    Raises when a source is missing or the compiler fails."""
    so = library_path(sources)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, *map(str, sources), "-o",
                           str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {[str(s) for s in sources]}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))

    def arr(dtype):
        return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")

    lib.cs_score_batch.restype = ctypes.c_int
    lib.cs_score_batch.argtypes = [
        arr(np.float32), arr(np.int32), arr(np.uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, arr(np.int32),
        arr(np.float64), arr(np.float64), arr(np.float64),
        arr(np.uint32), arr(np.float32), ctypes.c_int64,
        arr(np.float64), arr(np.float32), arr(np.float64), arr(np.uint8)]
    return lib


class NativeScorer:
    """Scores padded batches with ``cs_score_batch``.  Rows it does not
    handle (more than 60 atoms or 64 bonds, an element outside the
    10-element ABI) come back flagged, for the Python pipeline."""

    def __init__(self, dataset_info: dict,
                 sources: Sequence[Path] = SOURCES):
        self.lib = _load(build_library(tuple(sources)))
        decoder = dataset_info["atom_decoder"]
        self.n_types = len(decoder)
        self.elem = np.array([_ELEM_CODES.get(s, 10) for s in decoder],
                             np.int32)
        self._non_abi = self.elem == 10
        self.tables = [np.ascontiguousarray(dataset_info[k], np.float64)
                       .reshape(-1) for k in ("bonds1", "bonds2", "bonds3")]
        bits, scores = load_fpscores()
        self.fp_bits = np.ascontiguousarray(bits, np.uint32)
        self.fp_scores = np.ascontiguousarray(scores, np.float32)

    def score(self, coords: np.ndarray, types: np.ndarray, mask: np.ndarray,
              weights) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """coords [B, N, 3] Angstrom, types [B, N] indices, mask [B, N]
        bool; weights (w_qed, w_sa, w_lipinski, logp_k, logp_lo, logp_hi).
        Returns (rewards [B] float32, handled [B] bool, terms [B, 6]
        float64: valid, qed, sa, logp, lipinski, mw)."""
        bsz, n = types.shape
        if coords.shape != (bsz, n, 3) or mask.shape != (bsz, n):
            raise ValueError(f"coords {coords.shape}, types {types.shape} "
                             f"and mask {mask.shape} do not agree")
        if types.size and not (0 <= types.min()
                               and types.max() < self.n_types):
            raise ValueError("atom type index out of range")
        coords = np.ascontiguousarray(coords, np.float32)
        types = np.ascontiguousarray(types, np.int32)
        mask = np.ascontiguousarray(mask, np.uint8)
        w = np.asarray(list(weights[:6]), np.float64)
        rewards = np.zeros((bsz,), np.float32)
        terms = np.zeros((bsz, 6), np.float64)
        handled = np.zeros((bsz,), np.uint8)
        self.lib.cs_score_batch(
            coords.reshape(-1), types.reshape(-1), mask.reshape(-1),
            bsz, n, self.n_types, self.elem, *self.tables, self.fp_bits,
            self.fp_scores, len(self.fp_bits), w, rewards,
            terms.reshape(-1), handled)
        handled = handled.astype(bool)
        if self._non_abi.any():
            handled &= ~(self._non_abi[types] & (mask > 0)).any(axis=1)
        return rewards, handled, terms
