"""Processed ligand-pocket dataset: the reference's single npz per split
(flat node arrays with per-node sample indices), split per complex and
optionally centred on the joint centre of mass; padded batches in shape
buckets for training (``BucketedLoader``: the JAX package's batches, in
its order, from the same seed)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from diffndm_tpu_torch.structs import NodeBatch, from_lists


@dataclasses.dataclass
class LigandPocketPair:
    lig_coords: np.ndarray
    lig_one_hot: np.ndarray
    pocket_coords: np.ndarray
    pocket_one_hot: np.ndarray
    name: str = ""


class ProcessedLigandPocketDataset:
    def __init__(self, npz_path: str, center: bool = True):
        with np.load(npz_path, allow_pickle=True) as f:
            data = {k: v for k, v in f.items()}
        lig_sections = np.where(np.diff(data["lig_mask"]))[0] + 1
        pocket_key = ("pocket_coords" if "pocket_coords" in data
                      else "pocket_c_alpha")
        poc_sections = np.where(np.diff(data["pocket_mask"]))[0] + 1
        lig_coords = np.split(data["lig_coords"], lig_sections)
        lig_one_hot = np.split(data["lig_one_hot"], lig_sections)
        poc_coords = np.split(data[pocket_key], poc_sections)
        poc_one_hot = np.split(data["pocket_one_hot"], poc_sections)
        names = data.get("names",
                         np.array([f"complex_{i}"
                                   for i in range(len(lig_coords))]))
        self.pairs: List[LigandPocketPair] = []
        for lc, lh, pc, ph, nm in zip(lig_coords, lig_one_hot, poc_coords,
                                      poc_one_hot, names):
            lc = np.asarray(lc, np.float32)
            pc = np.asarray(pc, np.float32)
            if center:
                mean = (lc.sum(0) + pc.sum(0)) / (len(lc) + len(pc))
                lc = lc - mean
                pc = pc - mean
            self.pairs.append(LigandPocketPair(lc, np.asarray(lh, np.float32),
                                               pc,
                                               np.asarray(ph, np.float32),
                                               str(nm)))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx) -> LigandPocketPair:
        return self.pairs[idx]

    def size_histogram(self, smooth_sigma: float = 1.0) -> np.ndarray:
        """The smoothed joint (ligand size, pocket size) histogram."""
        from diffndm_tpu_torch.diffusion.node_distribution import \
            smoothed_histogram

        return smoothed_histogram([len(p.lig_coords) for p in self.pairs],
                                  [len(p.pocket_coords) for p in self.pairs],
                                  smooth_sigma)


def save_npz_split(path: str, pairs: List[LigandPocketPair]) -> None:
    """Write pairs in the flat npz layout that
    ``ProcessedLigandPocketDataset`` reads."""
    def index(arrays):
        return np.concatenate([np.full(len(a), i)
                               for i, a in enumerate(arrays)])

    lig = [p.lig_coords for p in pairs]
    poc = [p.pocket_coords for p in pairs]
    np.savez(path, names=np.array([p.name for p in pairs]),
             lig_coords=np.concatenate(lig),
             lig_one_hot=np.concatenate([p.lig_one_hot for p in pairs]),
             lig_mask=index(lig), pocket_coords=np.concatenate(poc),
             pocket_one_hot=np.concatenate([p.pocket_one_hot for p in pairs]),
             pocket_mask=index(poc))


def collate_padded(pairs: List[LigandPocketPair], lig_pad: int = 8,
                   pocket_pad: int = 64, drop_feature_cols: int = 0
                   ) -> Tuple[NodeBatch, NodeBatch]:
    """(ligand, pocket) NodeBatches of a list of pairs, each padded to a
    multiple of its pad; ``drop_feature_cols`` trailing one-hot columns
    (the padding types) are dropped."""
    def prep(oh):
        return oh[:, :oh.shape[1] - drop_feature_cols] \
            if drop_feature_cols else oh

    ligand = from_lists([p.lig_coords for p in pairs],
                        [prep(p.lig_one_hot) for p in pairs],
                        pad_multiple=lig_pad)
    pocket = from_lists([p.pocket_coords for p in pairs],
                        [prep(p.pocket_one_hot) for p in pairs],
                        pad_multiple=pocket_pad)
    return ligand, pocket


class BucketedLoader:
    """Padded batches of complexes of similar joint size: the complexes
    sorted by size, cut into batches, the batches shuffled per epoch by
    ``np.random.default_rng(seed)``; the last batch is filled cyclically.
    Batches lie on the CPU."""

    def __init__(self, dataset: ProcessedLigandPocketDataset,
                 batch_size: int, lig_pad: int = 8, pocket_pad: int = 64,
                 shuffle: bool = True, seed: int = 0,
                 drop_feature_cols: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.lig_pad = lig_pad
        self.pocket_pad = pocket_pad
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_feature_cols = drop_feature_cols
        sizes = np.array([len(p.lig_coords) + len(p.pocket_coords)
                          for p in dataset.pairs])
        self.order = np.argsort(sizes)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[NodeBatch, NodeBatch]]:
        batches = [self.order[i:i + self.batch_size]
                   for i in range(0, len(self.order), self.batch_size)]
        if self.shuffle:
            self.rng.shuffle(batches)
        for idxs in batches:
            pairs = [self.dataset[int(i)] for i in idxs]
            while len(pairs) < self.batch_size:
                pairs = pairs + pairs[: self.batch_size - len(pairs)]
            yield collate_padded(pairs, self.lig_pad, self.pocket_pad,
                                 self.drop_feature_cols)
