"""Sorted-band sparsity for the EGNN denoiser's edge chains.

Two atoms of the pocket whose projections onto the pocket's principal
axis lie further apart than the edge cutoff are further apart than the
cutoff in space, so they share no edge.  With the pocket sorted along that
axis, the edges of a tile of pocket rows lie in the ligand columns and in
a contiguous window of sorted pocket columns.  The JAX package computes
only those columns (``diffndm_tpu/models/banding.py``, the windows of
``diffndm_tpu/models/egnn.py::make_edge_contexts``); here the band is a
[N, N] mask that multiplies the adjacency, so the edge chains drop the
same pairs and compute only the edges that are left.

The window is exact when (window - row_tile) / 2 >= ``band_halfwidth_atoms``
of the pocket.  A narrower window (the facade's ``DIFFNDM_BAND_APPROX``)
drops real edges and changes the result; which ones depends on the order,
so the order must come out the same on every device.  The sign of an
eigenvector is up to the solver (cuSOLVER and CPU LAPACK differ), and a
flipped sign reverses the order.  So the 3 x 3 problem is solved on the
host by LAPACK's ``ssyevd`` (lower triangle, float32), the routine that
the JAX package's CPU backend calls for ``jnp.linalg.eigh``: the same
eigenvectors, to the bit, for the same covariance.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _principal_axes(cov: np.ndarray) -> np.ndarray:
    """[B, 3, 3] float32 covariances -> [B, 3] eigenvectors of the largest
    eigenvalue, from LAPACK's ssyevd on the lower triangle."""
    from scipy.linalg import lapack

    axes = np.empty((cov.shape[0], 3), np.float32)
    for i, c in enumerate(cov):
        _, vecs, info = lapack.ssyevd(c, compute_v=1, lower=1)
        if info != 0:
            raise RuntimeError(f"ssyevd failed on sample {i} (info {info})")
        axes[i] = vecs[:, -1]
    return axes


def principal_axis_order(pocket_x: torch.Tensor, pocket_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample permutation that sorts the real pocket atoms by their
    projection onto the pocket's principal axis, padding last.

    pocket_x: [B, NP, 3]; pocket_mask: [B, NP].  Returns (order [B, NP]
    int64, proj [B, NP], inf on padding).  The masked covariance and the
    projections are computed on the tensors' device; the 3 x 3
    eigenproblems on the host (one copy of [B, 3, 3] each way)."""
    m = pocket_mask[..., None]
    cnt = pocket_mask.sum(1, keepdim=True).clamp_min(1.0)
    com = (pocket_x * m).sum(1) / cnt
    centered = (pocket_x - com[:, None, :]) * m
    cov = torch.einsum("bni,bnj->bij", centered, centered) / cnt[..., None]
    axes = torch.from_numpy(_principal_axes(
        cov.detach().float().cpu().numpy())).to(pocket_x.device)
    proj = torch.einsum("bni,bi->bn", pocket_x, axes.to(pocket_x.dtype))
    proj = torch.where(pocket_mask > 0.5, proj,
                       torch.full_like(proj, float("inf")))
    order = torch.argsort(proj, dim=1, stable=True)
    return order, proj


def band_halfwidth_atoms(pocket_x, pocket_mask, cutoff: float) -> int:
    """The most sorted positions any real pocket atom must look back or
    forward to reach every atom within ``cutoff`` along the principal axis,
    over the batch (host NumPy).  A window with (window - row_tile) / 2 at
    least this wide is exact for the pocket."""
    pocket_x = np.asarray(pocket_x)
    pocket_mask = np.asarray(pocket_mask)
    worst = 0
    for b in range(pocket_x.shape[0]):
        xs = pocket_x[b][pocket_mask[b] > 0.5]
        if len(xs) < 2:
            continue
        c = xs - xs.mean(0)
        _, vecs = np.linalg.eigh(c.T @ c / len(xs))
        proj = np.sort(xs @ vecs[:, -1])
        j = np.searchsorted(proj, proj + cutoff, side="right")
        k = np.searchsorted(proj, proj - cutoff, side="left")
        idx = np.arange(len(proj))
        worst = max(worst, int((j - idx - 1).max()), int((idx - k).max()))
    return worst


def band_mask(n: int, n_lig: int, row_tile: int, window: int,
              device) -> torch.Tensor:
    """[N, N] float32: 1 where the band keeps the (row, column) pair.  The
    head tiles, the first ceil(n_lig / tile) tiles of rows, keep every
    column.  A later tile of rows from i0 keeps the ligand columns and the
    sorted pocket columns n_lig + [st, st + window), with st the tile's
    centre less half the window, clipped to the pocket block."""
    return _band_mask(n, n_lig, row_tile, window, str(device))


@functools.lru_cache(maxsize=32)
def _band_mask(n, n_lig, row_tile, window, device):
    tile = min(row_tile, n)
    np_total = n - n_lig
    h0 = -(-n_lig // tile) * tile
    mask = np.zeros((n, n), np.float32)
    mask[:h0] = 1.0
    mask[:, :n_lig] = 1.0
    for i0 in range(h0, n, tile):
        st = (i0 - n_lig) + tile // 2 - window // 2
        st = min(max(st, 0), max(np_total - window, 0))
        mask[i0:i0 + tile, n_lig + st:n_lig + st + window] = 1.0
    return torch.from_numpy(mask).to(device)
