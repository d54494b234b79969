"""The JAX side of the port's chemistry comparisons runs on the native
library, built once and atomically.

The JAX package's chemistry takes its kekulization matching and its ring
perception from ``native/libchemgraph.so``, which ``diffndm_tpu.chem.native``
builds in place with ``native/build.sh`` from every process that first
needs it, and it falls back to networkx's matching for the rest of the
process when a load fails.  Under several test workers on a tree with no
library, one worker can load a library that another is still writing: it
then crashes, or compares networkx's matching (which resolves ties to other
double bonds) against the port's deterministic blossom.

``pin_jax_native()`` builds the same two sources with the same flags once,
under a lock, into ``build/`` (temporary file, then ``os.replace``: the
port's ``chem/native.build_library``), points the JAX loader of this test
process at that file and asserts that it loads.  Every port test file whose
JAX side reaches the JAX chemistry calls it before its first comparison.
"""

import fcntl
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from diffndm_tpu.chem import native as jax_native  # noqa: E402
from diffndm_tpu_torch.chem import native as torch_native  # noqa: E402

LOCK_TIMEOUT_S = 300.0


def _build_once():
    """The port's atomic build under an exclusive lock, so that concurrent
    test workers compile it once; waits at most LOCK_TIMEOUT_S."""
    torch_native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(torch_native.BUILD_DIR / "chemscore.lock", "w") as lock:
        deadline = time.monotonic() + LOCK_TIMEOUT_S
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError("another process held the native "
                                       f"build lock for {LOCK_TIMEOUT_S} s")
                time.sleep(0.2)
        try:
            return torch_native.build_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def pin_jax_native():
    """Point ``diffndm_tpu.chem.native`` at the atomic build in this process
    and return its loaded library (never None)."""
    so = str(_build_once())
    if jax_native._lib_path() != so or jax_native._LIB is None:
        jax_native._lib_path = lambda: so
        jax_native._LIB, jax_native._TRIED = None, False
    lib = jax_native.load(build_if_missing=False)
    assert lib is not None, f"the JAX loader could not load {so}"
    return lib


def test_jax_loader_uses_the_atomic_build():
    lib = pin_jax_native()
    assert jax_native.load() is lib
    assert jax_native._lib_path() == str(torch_native.library_path())
    assert hasattr(lib, "cg_max_matching") and hasattr(lib, "cs_score_batch")
    # naphthalene: a perfect matching from the native blossom, the same on
    # every call
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0), (4, 6), (6, 7),
             (7, 8), (8, 9), (9, 5)]
    m = jax_native.max_matching_native(10, edges)
    assert m is not None and (np.asarray(m) >= 0).all()
    np.testing.assert_array_equal(jax_native.max_matching_native(10, edges),
                                  m)
    assert pin_jax_native() is lib
