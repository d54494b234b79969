"""The reward oracle across host workers: the native scorer over row
chunks on threads, the Python rows on spawned processes.  Rewards are
array_equal for every worker count, on both scorers, and equal to the
JAX package's Python pipeline on the populations of
tests/test_torch_oracle.py; the counters are summed in the caller;
``DIFFNDM_ORACLE_WORKERS`` sets the default; ``close()`` releases the
pools and ``DiffNDM`` closes its oracle.  The module that the spawned
workers import loads no torch."""

import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.guidance.oracle import \
    RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402
from test_torch_oracle import SPSA, SVDD, WINDOW, population  # noqa: E402

INFO = dataset_params["crossdock_full"]
CONN = SVDD + (0.0, 0.5)        # w_connectivity > 0: every row in Python


@pytest.fixture(scope="module")
def pop():
    return population()


@pytest.fixture(scope="module")
def jax_rewards(pop):
    out = {}
    for name, w in (("spsa", SPSA), ("svdd", SVDD), ("window", WINDOW),
                    ("conn", CONN)):
        oracle = JaxOracle(jax_params["crossdock_full"])
        oracle.native = None                # its pure-Python pipeline
        out[name] = oracle.score_batch_types(*pop, w)
    return out


@pytest.mark.parametrize("scorer", ["native", "python"])
@pytest.mark.parametrize("workers", [0, 2, 4])
def test_rewards_equal_for_every_worker_count(pop, jax_rewards, scorer,
                                              workers):
    coords, types, mask = pop
    with RewardOracle(INFO, scorer=scorer, num_workers=workers) as oracle:
        got = {name: oracle.score_batch_types(coords, types, mask, w)
               for name, w in (("spsa", SPSA), ("svdd", SVDD),
                               ("window", WINDOW), ("conn", CONN))}
        pools = (oracle._threads, oracle._processes)
    for name, ref in jax_rewards.items():
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], ref)
    n = len(coords)
    invalid = int((jax_rewards["svdd"] == 0).sum())
    assert oracle.n_calls == 4 and oracle.n_scored == 4 * n
    assert oracle.n_invalid == 4 * invalid and invalid >= 8
    # the native scorer hands the w_connectivity call to Python whole
    assert oracle.n_python_rows == 0
    assert oracle.seconds > 0
    # the pools exist exactly where workers were asked for, and are gone
    # after close()
    assert (pools[0] is not None) == (workers > 1 and scorer == "native")
    assert (pools[1] is not None) == (workers > 1)
    assert oracle._threads is None and oracle._processes is None


def test_flagged_native_rows_go_to_the_pool_and_are_counted():
    """Rows beyond the C++ scorer's bounds (70-atom chains) scored by the
    Python pipeline on two processes, counted once each in the caller."""
    n = 70
    coords = np.zeros((12, n, 3), np.float32)
    coords[:, :, 0] = np.arange(n) * 1.52
    coords[:, :, 1] = np.arange(12)[:, None] * 0.01
    types = np.zeros((12, n), np.int64)
    mask = np.ones((12, n), np.float32)
    mask[10:, 12:] = 0                      # two rows the C++ scorer takes
    ref = RewardOracle(INFO, scorer="python").score_batch_types(
        coords, types, mask, SVDD)
    with RewardOracle(INFO, scorer="native", num_workers=2) as oracle:
        r = oracle.score_batch_types(coords, types, mask, SVDD)
        assert oracle._processes is not None
    np.testing.assert_array_equal(r, ref)
    assert (oracle.n_python_rows, oracle.n_scored, oracle.n_invalid,
            oracle.n_calls) == (10, 12, 0, 1)


def test_workers_default_from_the_environment(monkeypatch, pop):
    monkeypatch.setenv("DIFFNDM_ORACLE_WORKERS", "3")
    oracle = RewardOracle(INFO, scorer="native")
    assert oracle.num_workers == 3
    r = oracle.score_batch_types(*pop, SVDD)
    assert oracle._threads is not None
    oracle.close()
    assert oracle._threads is None
    # a closed oracle scores again (its pool is made anew)
    np.testing.assert_array_equal(oracle.score_batch_types(*pop, SVDD), r)
    oracle.close()
    assert RewardOracle(INFO, scorer="native", num_workers=0).num_workers == 0
    monkeypatch.delenv("DIFFNDM_ORACLE_WORKERS")
    assert RewardOracle(INFO, scorer="python").num_workers == 0


def test_many_threads_short_switch_interval(pop):
    """More threads than cores, the interpreter switching threads every
    microsecond: rewards and counters as with one thread."""
    coords, types, mask = (np.concatenate([a] * 4) for a in pop)
    ref = RewardOracle(INFO, scorer="native", num_workers=0)
    r0 = ref.score_batch_types(coords, types, mask, SVDD)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        with RewardOracle(INFO, scorer="native", num_workers=32) as oracle:
            for _ in range(5):
                r = oracle.score_batch_types(coords, types, mask, SVDD)
                np.testing.assert_array_equal(r, r0)
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert oracle.n_scored == 5 * ref.n_scored
    assert oracle.n_invalid == 5 * ref.n_invalid


def test_diffndm_closes_its_oracle(monkeypatch):
    from diffndm_tpu_torch.config import (ATPConfig, ModelConfig,
                                          SampleConfig)
    from diffndm_tpu_torch.model import DiffNDM

    monkeypatch.setenv("DIFFNDM_ORACLE_WORKERS", "2")
    with DiffNDM(ModelConfig(), sample_cfg=SampleConfig(
            atp=ATPConfig(enabled=True)), device="cpu") as model:
        oracle = model.oracle
        assert oracle.num_workers == 2
        oracle.score_batch_types(*population(), SVDD)
        assert oracle._threads is not None
    assert oracle._threads is None
    DiffNDM(ModelConfig(), device="cpu").close()    # no oracle: nothing


def test_worker_module_loads_no_torch():
    """A spawned worker unpickles ``guidance.oracle.score_row``: importing
    that module must load the chem stack and not torch."""
    code = ("import sys, diffndm_tpu_torch.guidance.oracle as o; "
            "assert callable(o.score_row); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
