"""Molecule files and pictures: per-molecule xyz dumps and their reader,
3D renders of molecules to PNG and of a sampling chain to a GIF.
matplotlib and imageio are imported inside the plotting functions only:
the xyz functions need numpy alone.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence

import numpy as np


def save_xyz_file(path: str, one_hot: np.ndarray, positions: np.ndarray,
                  atom_decoder: Sequence[str], id_from: int = 0,
                  name: str = "molecule") -> List[str]:
    """One xyz file per molecule, ``<name>_<id>.txt``.  one_hot and
    positions are [B, N, ...] padded arrays; all-zero one-hot rows are
    padding and skipped."""
    os.makedirs(path, exist_ok=True)
    files = []
    for b in range(positions.shape[0]):
        keep = np.abs(one_hot[b]).sum(-1) > 0.5
        pos = positions[b][keep]
        types = one_hot[b][keep].argmax(-1)
        fn = os.path.join(path, f"{name}_{id_from + b:03d}.txt")
        with open(fn, "w") as f:
            f.write(f"{len(pos)}\n\n")
            for p, t in zip(pos, types):
                f.write(f"{atom_decoder[int(t)]} "
                        f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")
        files.append(fn)
    return files


def load_xyz_files(path: str) -> List[str]:
    return sorted(glob.glob(os.path.join(path, "*.txt")))


def load_molecule_xyz(file: str, atom_encoder: dict):
    with open(file) as f:
        lines = f.read().strip().splitlines()
    n = int(lines[0])
    pos, one_hot = [], []
    eye = np.eye(len(atom_encoder))
    for line in lines[2:2 + n]:
        parts = line.split()
        pos.append([float(v) for v in parts[1:4]])
        one_hot.append(eye[atom_encoder[parts[0]]])
    return np.array(pos), np.array(one_hot)


_COLORS = {"C": "#33ff33", "N": "#3333ff", "O": "#ff4d4d", "S": "#e6c540",
           "B": "#ffb5b5", "Br": "#A62929", "Cl": "#1FF01F", "P": "#ff8000",
           "I": "#940094", "F": "#B3FFFF"}


def plot_molecule_3d(positions: np.ndarray, types: Sequence[str],
                     bonds: Optional[Sequence] = None, save_path=None,
                     alpha: float = 1.0):
    """One molecule as a 3D scatter with its bonds; written to save_path
    (returned), or the figure returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    colors = [_COLORS.get(t, "#999999") for t in types]
    ax.scatter(positions[:, 0], positions[:, 1], positions[:, 2],
               c=colors, s=120, alpha=alpha, edgecolors="k")
    if bonds is not None:
        for i, j, _ in bonds:
            ax.plot(*zip(positions[i], positions[j]), c="#444444",
                    linewidth=1.5, alpha=alpha)
    ax.set_axis_off()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def visualize_molecules(sdf_path: str, out_dir: str) -> List[str]:
    """Render every molecule in an SDF to PNG."""
    from diffndm_tpu_torch.chem.io import read_sdf

    os.makedirs(out_dir, exist_ok=True)
    out = []
    for i, mol in enumerate(read_sdf(sdf_path)):
        png = os.path.join(out_dir, f"mol_{i:03d}.png")
        plot_molecule_3d(np.asarray(mol.coords), mol.symbols, mol.bonds,
                         save_path=png)
        out.append(png)
    return out


def visualize_chain(frames: Sequence[np.ndarray],
                    types_per_frame: Sequence[Sequence[str]],
                    out_gif: str, fps: int = 8) -> str:
    """A denoising trajectory as a GIF, one rendered frame per step."""
    import imageio.v2 as imageio
    import tempfile

    images = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (pos, types) in enumerate(zip(frames, types_per_frame)):
            png = os.path.join(tmp, f"f{i:04d}.png")
            plot_molecule_3d(pos, types, save_path=png)
            images.append(imageio.imread(png))
    imageio.mimsave(out_gif, images, fps=fps)
    return out_gif
