"""The port's CA backbone frames (``utils/geometry.py``) against the JAX
package's, on seeded rigid transforms of the canonical N-CA-C triangle:
the same frames, quaternions and rotations (atol 1e-12, float64 on both
sides), and the roundtrips of tests/test_utils_aux.py (backbone -> frame
-> backbone, quaternion -> rotation -> quaternion) within 1e-6."""

import numpy as np
import pytest

from diffndm_tpu.utils import geometry as jgeo
from diffndm_tpu_torch.utils import geometry as tgeo


def random_backbones(rng, n=16):
    qs = rng.normal(size=(n, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    ts = rng.normal(size=(n, 3)) * 10
    R = tgeo.quaternion_to_rotation_matrix(qs)
    bb = np.einsum("nij,kj->nki", R, tgeo.CANONICAL_BB) + ts[:, None, :]
    return qs, bb


def test_canonical_frame_equals_jax():
    np.testing.assert_array_equal(tgeo.CANONICAL_BB, jgeo.CANONICAL_BB)


def test_bb_transform_roundtrip_and_equals_jax():
    rng = np.random.default_rng(0)
    _, bb = random_backbones(rng)
    n_xyz, ca_xyz, c_xyz = bb[:, 0], bb[:, 1], bb[:, 2]
    q, t = tgeo.get_bb_transform(n_xyz, ca_xyz, c_xyz)
    qj, tj = jgeo.get_bb_transform(n_xyz, ca_xyz, c_xyz)
    np.testing.assert_allclose(q, qj, atol=1e-12)
    np.testing.assert_allclose(t, tj, atol=1e-12)
    coords, types = tgeo.get_bb_coords_from_transform(ca_xyz, q)
    cj, tyj = jgeo.get_bb_coords_from_transform(ca_xyz, qj)
    np.testing.assert_allclose(coords, cj, atol=1e-12)
    assert types == tyj and types[:3] == ["N", "C", "C"]
    np.testing.assert_allclose(coords.reshape(-1, 3, 3), bb, atol=1e-6)


def test_quaternion_roundtrip_and_equals_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(8, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[q[:, 0] < 0] *= -1
    # 180-degree rotations about each axis: traces of -1
    q = np.concatenate([q, np.eye(4)[1:]])
    R = tgeo.quaternion_to_rotation_matrix(q)
    np.testing.assert_allclose(R, jgeo.quaternion_to_rotation_matrix(q),
                               atol=1e-12)
    q2 = tgeo.rotation_matrix_to_quaternion(R)
    np.testing.assert_allclose(q2, jgeo.rotation_matrix_to_quaternion(R),
                               atol=1e-12)
    q2[q2[:, 0] < 0] *= -1
    np.testing.assert_allclose(np.abs(q), np.abs(q2), atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotation_matrix_equals_jax(axis):
    angle = np.linspace(-np.pi, np.pi, 7)
    R = tgeo.rotation_matrix(angle, axis)
    np.testing.assert_array_equal(R, jgeo.rotation_matrix(angle, axis))
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2),
                               np.tile(np.eye(3), (7, 1, 1)), atol=1e-12)
