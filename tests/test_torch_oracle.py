"""The port's reward oracle: its Python scorer, its native scorer (built
here by g++ from native/*.cpp into build/) and the JAX package's Python
pipeline return the same float32 rewards, array_equal, for the SPSA and
the SVDD weight profiles, with the connectivity and affinity terms; the scorer
is an explicit choice and "native" raises when it cannot be built;
invalid molecules are counted."""

import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.guidance.oracle import \
    RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu_torch.chem import native as tnative  # noqa: E402
from diffndm_tpu_torch.config import ATPConfig, SPSAConfig  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402

INFO = dataset_params["crossdock_full"]
SPSA = (2.0, 3.0, 0.2, 0.0, 0.0, 0.0)
SVDD = (2.0, 2.0, 0.2, 20.0, -1.0, 5.0)
WINDOW = (2.0, 3.0, 0.2, 1.0, -1.0, 4.0)   # a soft LogP window


def pad(items):
    n = max(len(t) for _, t in items)
    coords = np.zeros((len(items), n, 3), np.float32)
    types = np.zeros((len(items), n), np.int64)
    mask = np.zeros((len(items), n), np.float32)
    for i, (c, t) in enumerate(items):
        coords[i, :len(t)], types[i, :len(t)], mask[i, :len(t)] = c, t, 1
    return coords, types, mask


def population(seed=0):
    """Test ligands clean and perturbed (partly invalid, as guidance
    populations are), a benzene ring, and pure noise."""
    rng = np.random.default_rng(seed)
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    items = [(ds[i].lig_coords, ds[i].lig_one_hot.argmax(-1))
             for i in range(24)]
    items += [(c + rng.normal(size=c.shape) * s, t)
              for c, t in list(items) for s in (0.1, 0.4)]
    theta = np.linspace(0, 2 * np.pi, 7)[:6]
    items.append((np.stack([1.39 * np.cos(theta), 1.39 * np.sin(theta),
                            np.zeros(6)], -1), np.zeros(6, np.int64)))
    items += [(rng.normal(size=(n, 3)) * 1.5, rng.integers(0, 10, size=n))
              for n in (4, 9, 17, 26) for _ in range(4)]
    return pad(items)


def jax_python_rewards(coords, types, mask, weights):
    oracle = JaxOracle(jax_params["crossdock_full"])
    oracle.native = None                    # its pure-Python pipeline
    return oracle.score_batch_types(coords, types, mask, weights), oracle


@pytest.mark.parametrize("weights", [SPSA, SVDD, WINDOW],
                         ids=["spsa", "svdd", "window"])
def test_python_native_and_jax_rewards_equal(weights):
    coords, types, mask = population()
    ref, jax_oracle = jax_python_rewards(coords, types, mask, weights)
    py = RewardOracle(INFO, scorer="python")
    nat = RewardOracle(INFO, scorer="native")
    r_py = py.score_batch_types(coords, types, mask, weights)
    r_nat = nat.score_batch_types(coords, types, mask, weights)
    assert r_py.dtype == r_nat.dtype == np.float32
    np.testing.assert_array_equal(r_py, ref)
    np.testing.assert_array_equal(r_nat, ref)
    assert (ref > 0).sum() >= 24 and (ref == 0).sum() >= 8
    # the same molecules counted invalid on every path
    assert py.n_scored == nat.n_scored == jax_oracle.n_scored == len(ref)
    assert py.n_invalid == nat.n_invalid == jax_oracle.n_invalid > 0
    assert nat.n_python_rows == 0 and nat.n_calls == 1
    assert py.invalid_rate == py.n_invalid / len(ref)


def test_rows_the_native_scorer_does_not_take_go_through_python():
    """A 70-atom chain is beyond the C++ scorer's bounds: it flags the row
    and the oracle scores it in Python, with the same reward as the Python
    scorer, and counts it."""
    n = 70
    coords = np.zeros((2, n, 3), np.float32)
    coords[:, :, 0] = np.arange(n) * 1.52
    types = np.zeros((2, n), np.int64)
    mask = np.ones((2, n), np.float32)
    mask[1, 12:] = 0
    nat = RewardOracle(INFO, scorer="native")
    _, handled, _ = nat.native.score(coords, types, mask > 0.5, SVDD)
    assert handled.tolist() == [False, True]
    r_nat = nat.score_batch_types(coords, types, mask, SVDD)
    r_py = RewardOracle(INFO, scorer="python").score_batch_types(
        coords, types, mask, SVDD)
    np.testing.assert_array_equal(r_nat, r_py)
    assert nat.n_python_rows == 1 and nat.n_scored == 2 and r_nat[0] > 0


def test_native_raises_when_it_cannot_be_built(tmp_path):
    with pytest.raises(FileNotFoundError):
        RewardOracle(INFO, scorer="native",
                     native_sources=(tmp_path / "missing.cpp",))
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        RewardOracle(INFO, scorer="native", native_sources=(broken,))
    with pytest.raises(ValueError, match="scorer"):
        RewardOracle(INFO, scorer="auto")


def test_native_build_lands_in_build_not_in_native():
    before = sorted(os.listdir("native"))
    so = tnative.build_library()
    assert so.parent == Path("build").resolve() and so.exists()
    assert sorted(os.listdir("native")) == before
    assert tnative.library_path() == so     # cached by source hash


def test_connectivity_term_and_vina_refusal():
    coords, types, mask = population()
    coords, types, mask = coords[:30], types[:30], mask[:30]
    weights = SVDD + (0.0, 0.7)
    ref, _ = jax_python_rewards(coords, types, mask, weights)
    for scorer in ("python", "native"):
        oracle = RewardOracle(INFO, scorer=scorer)
        np.testing.assert_array_equal(
            oracle.score_batch_types(coords, types, mask, weights), ref)
    base = RewardOracle(INFO, scorer="python").score_batch_types(
        coords, types, mask, SVDD)
    assert (ref[base > 0] > base[base > 0]).all()
    # w_vina: the affinity term against a receptor, == JAX's (more in
    # tests/test_torch_scoring.py)
    from diffndm_tpu.chem.scoring import VinaScorer as JaxVina
    from diffndm_tpu_torch.chem.scoring import VinaScorer

    rec = np.random.default_rng(2).normal(size=(40, 3)) * 4.0
    elements = ["C", "N", "O", "S"] * 10
    jax_oracle = JaxOracle(jax_params["crossdock_full"])
    jax_oracle.native = None
    jax_oracle.set_receptor(JaxVina(rec, elements))
    oracle.set_receptor(VinaScorer(rec, elements))
    weights = SVDD + (1.0,)
    got = oracle.score_batch_types(coords, types, mask, weights)
    np.testing.assert_array_equal(
        got, jax_oracle.score_batch_types(coords, types, mask, weights))
    assert (got != base).sum() > 10


@pytest.mark.parametrize("profile", ["spsa", "svdd"])
def test_tensor_rewards_take_argmax_types_and_keep_the_device(profile):
    """``spsa_rewards`` / ``svdd_rewards`` take coordinates and raw type
    scores as tensors and return a [B] float32 tensor equal to the host
    scoring of the argmax types under that profile's weights."""
    coords, types, mask = population()
    rng = np.random.default_rng(1)
    scores = rng.normal(size=types.shape + (10,)).astype(np.float32) * 0.1
    np.put_along_axis(scores, types[..., None], 1.0, -1)
    oracle = RewardOracle(INFO, scorer="native")
    cfg = SPSAConfig() if profile == "spsa" else ATPConfig()
    fn = oracle.spsa_rewards if profile == "spsa" else oracle.svdd_rewards
    out = fn(torch.from_numpy(coords), torch.from_numpy(scores),
             torch.from_numpy(mask), cfg)
    assert out.dtype == torch.float32 and out.shape == (len(types),)
    want = oracle.score_batch_types(coords, types, mask,
                                    SPSA if profile == "spsa" else SVDD)
    np.testing.assert_array_equal(out.numpy(), want)
    assert oracle.n_calls == 2 and oracle.seconds > 0
