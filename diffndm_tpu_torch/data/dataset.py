"""Processed ligand-pocket dataset: the reference's single npz per split
(flat node arrays with per-node sample indices), split per complex and
optionally centred on the joint centre of mass."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


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
