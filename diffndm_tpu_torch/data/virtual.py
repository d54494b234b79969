"""Virtual nodes: ligands padded to a fixed size with atoms of a
dedicated 'virtual' type placed around the ligand's centre of mass; the
loss masks their coordinate error (``DiffusionConfig.virtual_node_idx``)
and decoded virtual atoms are stripped before molecules are built."""

from __future__ import annotations

import numpy as np

from diffndm_tpu_torch.data.dataset import LigandPocketPair
from diffndm_tpu_torch.structs import NodeBatch


class AppendVirtualNodes:
    """Transform a LigandPocketPair so that every ligand has exactly
    max_ligand_size atoms; the extra atoms get the virtual one-hot class,
    their coordinates ~ N(ligand COM, largest coordinate std)."""

    def __init__(self, max_ligand_size: int, atom_encoder: dict,
                 symbol: str = "others", seed: int = 0):
        self.max_ligand_size = max_ligand_size
        self.atom_encoder = atom_encoder
        self.vidx = atom_encoder[symbol]
        self.rng = np.random.default_rng(seed)

    def __call__(self, pair: LigandPocketPair) -> LigandPocketPair:
        n = len(pair.lig_coords)
        n_virt = self.max_ligand_size - n
        if n_virt <= 0:
            return pair
        mu = pair.lig_coords.mean(0, keepdims=True)
        sigma = float(pair.lig_coords.std(0).max())
        virt_coords = (self.rng.normal(size=(n_virt, 3)) * sigma
                       + mu).astype(pair.lig_coords.dtype)
        n_classes = len(self.atom_encoder)
        one_hot = pair.lig_one_hot
        if one_hot.shape[1] < n_classes:
            # insert the virtual class column
            one_hot = np.concatenate(
                [one_hot[:, :self.vidx], np.zeros((n, 1), one_hot.dtype),
                 one_hot[:, self.vidx:]], axis=1)
        virt_one_hot = np.zeros((n_virt, n_classes), one_hot.dtype)
        virt_one_hot[:, self.vidx] = 1.0
        return LigandPocketPair(
            np.concatenate([pair.lig_coords, virt_coords]),
            np.concatenate([one_hot, virt_one_hot]),
            pair.pocket_coords, pair.pocket_one_hot, pair.name)


def strip_virtual_nodes(batch: NodeBatch, vidx: int) -> NodeBatch:
    """Zero out decoded virtual atoms so that molecule building ignores
    them."""
    keep = (batch.h.argmax(-1) != vidx).to(batch.mask.dtype) * batch.mask
    return NodeBatch(x=batch.x * keep[..., None], h=batch.h * keep[..., None],
                     mask=keep)
