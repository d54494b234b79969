"""The general generator of the benchmark's inputs, driven by a traffic
file's parameters (``benchmark/traffic/<name>.json``): pockets, ligand
sizes, the noise the sampler injects and training pairs.  Every draw
comes from the run's seed; what a seed changes is the data and its
order, never the amount of work.

Frozen copies: ``synthetic_pocket`` is the rule of ``chip_smoke.py``'s
``flagship_inputs`` (repository commit c481f2b): atoms uniform in a ball
at protein density; ``test_set_pockets`` reads the processed split as
``diffndm_tpu_torch/data/dataset.ProcessedLigandPocketDataset`` does
(commit c481f2b): per-complex sections of the flat arrays, centred on the
complex's joint centre of mass; ``default_histogram`` is the facade's
size prior, ``diffndm_tpu_torch/diffusion/node_distribution.py``
(commit c481f2b).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

Pocket = Tuple[np.ndarray, np.ndarray]       # coordinates [P, 3], one-hot [P, F]


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of the run's seed."""
    return np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, *stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on the device for one stream of the seed."""
    sub = int(rng(seed, stream).integers(0, 2 ** 62))
    return torch.Generator(device=device).manual_seed(sub)


def synthetic_pocket(seed: int, atoms: int, density: float,
                     type_probs: List[float]) -> Pocket:
    """``atoms`` atoms uniform in a ball of radius (3 atoms / (4 pi
    density))^(1/3) A, types drawn from ``type_probs`` (one-hot over its
    length)."""
    g = rng(seed, 1)
    radius = (3 * atoms / (4 * np.pi * density)) ** (1 / 3)
    pts = g.normal(size=(atoms, 3))
    pts *= (radius * g.uniform(size=(atoms, 1)) ** (1 / 3)
            / np.linalg.norm(pts, axis=-1, keepdims=True))
    p = np.asarray(type_probs, np.float64)
    types = g.choice(len(p), size=atoms, p=p / p.sum())
    onehot = np.eye(len(p), dtype=np.float32)[types]
    return pts.astype(np.float32), onehot


def synthetic_pairs(seed: int, count: int, pocket: dict, ligand: dict):
    """``count`` training pairs, each a ``synthetic_pocket`` of its own
    and a ligand of ``ligand["atoms"]`` atoms, normal with standard
    deviation ``ligand["spread"]`` A about the pocket's centre (the rule
    of ``flagship_inputs``), types drawn from ``ligand["type_probs"]``.
    Returns arrays (x_lig [P, NL, 3], h_lig [P, NL, F], x_poc [P, NP,
    3], h_poc [P, NP, F])."""
    out = [[], [], [], []]
    for i in range(count):
        pc, ph = synthetic_pocket(seed * 1000003 + i, pocket["atoms"],
                                  pocket["density"], pocket["type_probs"])
        g = rng(seed, 4, i)
        lc = g.normal(size=(ligand["atoms"], 3)) * ligand["spread"]
        p = np.asarray(ligand["type_probs"], np.float64)
        types = g.choice(len(p), size=ligand["atoms"], p=p / p.sum())
        for lst, arr in zip(out, (lc, np.eye(len(p))[types], pc, ph)):
            lst.append(np.asarray(arr, np.float32))
    return tuple(np.stack(v) for v in out)


def test_set_pockets(path: str, first: int) -> List[Pocket]:
    """The first ``first`` complexes' pockets of a processed split
    (``lig_*`` / ``pocket_*`` arrays with per-node section masks),
    centred as the dataset centres them."""
    with np.load(path, allow_pickle=True) as f:
        data = {k: f[k] for k in f.files}
    lig_cut = np.where(np.diff(data["lig_mask"]))[0] + 1
    poc_cut = np.where(np.diff(data["pocket_mask"]))[0] + 1
    lig = np.split(data["lig_coords"], lig_cut)
    poc = np.split(data["pocket_coords"], poc_cut)
    poc_h = np.split(data["pocket_one_hot"], poc_cut)
    out = []
    for lc, pc, ph in list(zip(lig, poc, poc_h))[:first]:
        lc, pc = np.asarray(lc, np.float32), np.asarray(pc, np.float32)
        mean = (lc.sum(0) + pc.sum(0)) / (len(lc) + len(pc))
        out.append(((pc - mean).astype(np.float32),
                    np.asarray(ph, np.float32)))
    return out


def pad_to(n: int, multiple: int) -> int:
    return int(-(-n // multiple) * multiple)


def pocket_batch(pockets: List[Pocket], per_pocket: int, nf: int,
                 pad_multiple: int, device):
    """Each pocket repeated ``per_pocket`` times, padded to a common
    size rounded up to ``pad_multiple``; the one-hot cut to ``nf``
    columns.  Returns (x, h, mask) on the device."""
    npad = pad_to(max(len(p) for p, _ in pockets), pad_multiple)
    b = len(pockets) * per_pocket
    x = np.zeros((b, npad, 3), np.float32)
    h = np.zeros((b, npad, nf), np.float32)
    mask = np.zeros((b, npad), np.float32)
    for i, (pc, ph) in enumerate(pockets):
        rows = slice(i * per_pocket, (i + 1) * per_pocket)
        x[rows, :len(pc)] = pc
        h[rows, :len(pc)] = ph[:, :nf]
        mask[rows, :len(pc)] = 1.0
    return tuple(torch.from_numpy(a).to(device) for a in (x, h, mask))


def default_histogram(max_lig: int = 48, max_pocket: int = 600
                      ) -> np.ndarray:
    """The joint (ligand size, pocket size) histogram the facade samples
    sizes from without a dataset: ligand sizes ~N(24, 8), pocket sizes
    ~N(350, 120), mildly correlated, no ligand under 6 atoms."""
    li = np.arange(max_lig + 1)[:, None]
    pi = np.arange(max_pocket + 1)[None, :]
    mu_l = 24.0 + 0.01 * (pi - 350.0)
    hist = np.exp(-0.5 * ((li - mu_l) / 8.0) ** 2
                  - 0.5 * ((pi - 350.0) / 120.0) ** 2)
    hist[:6, :] = 0
    return hist


def prior_sizes(histogram: np.ndarray, pocket_sizes: np.ndarray,
                size_seed: int, seed: int, per_pocket: int) -> np.ndarray:
    """Ligand sizes N ~ p(N | pocket size) of a joint (ligand, pocket)
    size histogram, at least 2, drawn once from ``size_seed`` (the same
    multiset for every run), then shuffled within each pocket's rows by
    the run's seed."""
    g = rng(size_seed, 2)
    p = np.asarray(histogram, np.float64) + 1e-3
    p = p / p.sum()
    cond = p / p.sum(axis=0, keepdims=True)
    cols = np.clip(pocket_sizes, 0, p.shape[1] - 1)
    sizes = np.array([g.choice(p.shape[0], p=cond[:, c]) for c in cols])
    sizes = np.maximum(sizes, 2)
    order = rng(seed, 3)
    for i in range(0, len(sizes), per_pocket):
        sizes[i:i + per_pocket] = order.permutation(sizes[i:i + per_pocket])
    return sizes


def ligand_mask(sizes: np.ndarray, pad_multiple: int, device):
    nl = pad_to(int(sizes.max()), pad_multiple)
    mask = (np.arange(nl)[None] < sizes[:, None]).astype(np.float32)
    return torch.from_numpy(mask).to(device)


def repo_path(root: str, rel: str) -> str:
    path = os.path.normpath(os.path.join(root, rel))
    if not path.startswith(os.path.normpath(root) + os.sep):
        raise ValueError(f"{rel!r} leads out of the checkout")
    return path
