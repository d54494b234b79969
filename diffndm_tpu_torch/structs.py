"""Padded batch container.

A batch of point clouds is a ``NodeBatch`` of padded tensors
(x [B, N, 3], h [B, N, F], mask [B, N]) with zeros in the padding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class NodeBatch(NamedTuple):
    """x: [B, N, 3] coordinates; h: [B, N, F] features / one-hot types;
    mask: [B, N], 1.0 for real nodes and 0.0 for padding."""

    x: torch.Tensor
    h: torch.Tensor
    mask: torch.Tensor

    @property
    def size(self) -> torch.Tensor:
        """Number of real nodes per sample, [B]."""
        return self.mask.sum(dim=1)

    def to(self, device) -> "NodeBatch":
        return NodeBatch(self.x.to(device), self.h.to(device),
                         self.mask.to(device))


def pad_to(n: int, multiple: int) -> int:
    """Round up to a padding bucket."""
    return int(-(-n // multiple) * multiple)


def from_lists(coords_list, onehot_list, n_max: Optional[int] = None,
               pad_multiple: int = 8, device="cpu") -> NodeBatch:
    """Build a padded float32 NodeBatch from per-sample numpy arrays."""
    sizes = [len(c) for c in coords_list]
    if n_max is None:
        n_max = pad_to(max(sizes), pad_multiple)
    b = len(coords_list)
    f = onehot_list[0].shape[1]
    x = np.zeros((b, n_max, 3), dtype=np.float32)
    h = np.zeros((b, n_max, f), dtype=np.float32)
    mask = np.zeros((b, n_max), dtype=np.float32)
    for i, (c, o) in enumerate(zip(coords_list, onehot_list)):
        n = len(c)
        x[i, :n] = c
        h[i, :n] = o
        mask[i, :n] = 1.0
    return NodeBatch(torch.from_numpy(x).to(device),
                     torch.from_numpy(h).to(device),
                     torch.from_numpy(mask).to(device))


def to_lists(batch: NodeBatch):
    """Split a padded batch into per-sample (coords, type_idx) numpy
    arrays, the host-side decode before molecule building."""
    x = batch.x.detach().cpu().numpy()
    h = batch.h.detach().cpu().numpy()
    mask = batch.mask.detach().cpu().numpy() > 0.5
    return [(x[i][mask[i]], h[i][mask[i]].argmax(axis=-1))
            for i in range(x.shape[0])]


def pad_nodes(batch: NodeBatch, n_target: int) -> NodeBatch:
    """Grow the node axis to n_target with zero padding."""
    n = batch.x.shape[1]
    if n >= n_target:
        return batch
    grow = n_target - n
    return NodeBatch(torch.nn.functional.pad(batch.x, (0, 0, 0, grow)),
                     torch.nn.functional.pad(batch.h, (0, 0, 0, grow)),
                     torch.nn.functional.pad(batch.mask, (0, grow)))


def concat_batches(batches) -> NodeBatch:
    """Concatenate NodeBatches along the sample axis, the node axis padded
    to the largest (several pockets in one batch)."""
    n_max = max(b.x.shape[1] for b in batches)
    padded = [pad_nodes(b, n_max) for b in batches]
    return NodeBatch(*(torch.cat([b[i] for b in padded]) for i in range(3)))
