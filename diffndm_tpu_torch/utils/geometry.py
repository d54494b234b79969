"""Backbone frames for CA-only pockets (NumPy).

A residue's N, CA and C atoms are its canonical N-CA-C triangle (CA at the
origin, N on +x, C in the xy-plane) under a rotation, given as a unit
quaternion (w, x, y, z), and the CA position as translation.
``get_bb_transform`` finds the frame of each residue and
``get_bb_coords_from_transform`` rebuilds the backbone from it; the two
are inverse for ideal geometry.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from diffndm_tpu_torch.constants import CA_C_DIST, N_CA_C_ANGLE, N_CA_DIST

# canonical frame: CA at the origin, N on +x, C in the xy-plane
CANONICAL_BB = np.array([
    [N_CA_DIST, 0.0, 0.0],
    [0.0, 0.0, 0.0],
    [CA_C_DIST * np.cos(N_CA_C_ANGLE), CA_C_DIST * np.sin(N_CA_C_ANGLE),
     0.0],
])


def _normalize(v, eps=1e-12):
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + eps)


def get_bb_transform(n_xyz: np.ndarray, ca_xyz: np.ndarray,
                     c_xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The pose of each residue's backbone frame: (quaternion [n, 4],
    translation [n, 3]) such that ``R(q) @ canonical + t`` gives the
    backbone atoms."""
    t = ca_xyz
    n_local = n_xyz - t
    c_local = c_xyz - t
    # orthonormal frame: e1 along N, e2 in the (N, C) plane, e3 normal
    e1 = _normalize(n_local)
    c_perp = c_local - (c_local * e1).sum(-1, keepdims=True) * e1
    e2 = _normalize(c_perp)
    e3 = np.cross(e1, e2)
    # the rotation taking the canonical axes onto (e1, e2, e3): columns
    R = np.stack([e1, e2, e3], axis=-1)
    return rotation_matrix_to_quaternion(R), t


def get_bb_coords_from_transform(ca_coords: np.ndarray,
                                 quaternion: np.ndarray
                                 ) -> Tuple[np.ndarray, List[str]]:
    """The inverse of ``get_bb_transform``: the [N, CA, C] coordinates of
    each residue as [3n, 3], and their element types."""
    R = quaternion_to_rotation_matrix(quaternion)  # [n, 3, 3]
    bb = np.einsum("nij,kj->nki", R, CANONICAL_BB)  # [n, 3, 3]
    bb = bb + ca_coords[:, None, :]
    types = [t for _ in range(len(ca_coords)) for t in ("N", "C", "C")]
    return bb.reshape(-1, 3), types


def quaternion_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    q = q / np.sqrt((q ** 2).sum(-1, keepdims=True))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Shepperd's conversion, stable for every trace (a rotation by 180
    degrees included)."""
    n = R.shape[0]
    q = np.zeros((n, 4))
    t = np.einsum("nii->n", R)
    for i in range(n):
        m = R[i]
        tr = t[i]
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s,
                    (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            q[i] = [(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                    (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        elif m[1, 1] >= m[2, 2]:
            s = np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
            q[i] = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                    0.25 * s, (m[1, 2] + m[2, 1]) / s]
        else:
            s = np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
            q[i] = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                    (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    return q


def rotation_matrix(angle: np.ndarray, axis: int) -> np.ndarray:
    """Batched rotations [n, 3, 3] about one axis (0 = x, 1 = y,
    2 = z)."""
    n = len(angle)
    c, s = np.cos(angle), np.sin(angle)
    R = np.tile(np.eye(3), (n, 1, 1))
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    R[:, i, i] = c
    R[:, j, j] = c
    if axis == 1:
        R[:, i, j] = s
        R[:, j, i] = -s
    else:
        R[:, i, j] = -s
        R[:, j, i] = s
    return R
