"""The port's padded batch container and masked reductions against the
JAX package's, on the same seeded inputs.  Padding and masking are exact;
the reductions agree to rtol 1e-6, atol 1e-6 (fp32 sums in another
order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import structs as jstructs  # noqa: E402
from diffndm_tpu.ops import segment as jseg  # noqa: E402
from diffndm_tpu_torch import structs  # noqa: E402
from diffndm_tpu_torch.ops import segment  # noqa: E402

RTOL = ATOL = 1e-6


def test_from_lists_to_lists_and_pad_to():
    rng = np.random.default_rng(0)
    sizes = [5, 11, 1]
    coords = [rng.normal(size=(n, 3)).astype(np.float32) for n in sizes]
    onehot = [np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
              for n in sizes]
    ours = structs.from_lists(coords, onehot)
    ref = jstructs.from_lists(coords, onehot)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ours.size.numpy(), np.asarray(ref.size))
    for (c, t), (rc, rt) in zip(structs.to_lists(ours),
                                jstructs.to_lists(ref)):
        np.testing.assert_array_equal(c, rc)
        np.testing.assert_array_equal(t, rt)
    for n, m in [(1, 8), (8, 8), (9, 8), (41, 16), (0, 64)]:
        assert structs.pad_to(n, m) == jstructs.pad_to(n, m)


def test_masked_reductions_and_remove_mean_ligand():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 9, 3)).astype(np.float32)
    xp = rng.normal(size=(3, 14, 3)).astype(np.float32)
    lm = (rng.uniform(size=(3, 9)) > 0.3).astype(np.float32)
    pm = (rng.uniform(size=(3, 14)) > 0.3).astype(np.float32)
    lm[2] = 0  # an empty sample divides by the eps floor on both sides
    t = [torch.from_numpy(a) for a in (x, xp, lm, pm)]

    def close(out, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)

    close(segment.masked_sum(t[0], t[2]), jseg.masked_sum(x, lm))
    close(segment.masked_sum(t[0], t[2], dim=1, keepdim=True),
          jseg.masked_sum(x, lm, axis=1, keepdims=True))
    close(segment.masked_mean(t[0], t[2]), jseg.masked_mean(x, lm))
    close(segment.sum_except_batch(t[0], t[2]),
          jseg.sum_except_batch(x, lm))
    for o, r in zip(segment.remove_mean_ligand(*t),
                    jseg.remove_mean_ligand(*(jnp.asarray(a) for a in
                                              (x, xp, lm, pm)))):
        close(o, r)
