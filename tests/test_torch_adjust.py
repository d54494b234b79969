"""The port's AdjustNet (RL noise adjustment) against the JAX package's:
the forward on weights carried over by ``adjust_params_from_jax`` (atol
1e-6), three REINFORCE updates of ``rl_update`` on the same trajectory
stacks and ligands (loss, grad norm and parameters after each step within
atol 1e-6 + rtol 1e-5: optax's and torch's Adam differ only in rounding;
the rewards, from the real chemistry oracles, equal), a zero reward that
moves nothing, and ``.npz`` checkpoints that load in the other package
with parameters and Adam moments and count equal.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.diffusion.sampler import ConditionalSampler as JaxSampler  # noqa: E402
from diffndm_tpu.diffusion.sampler import SampleResult as JaxResult  # noqa: E402
from diffndm_tpu.guidance.oracle import RewardOracle as JaxOracle  # noqa: E402
from diffndm_tpu.models.adjust_net import \
    AdjustNetState as JaxAdjust  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxBatch  # noqa: E402
from diffndm_tpu_torch.config import RLConfig, SampleConfig  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.convert import adjust_params_from_jax  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.diffusion.sampler import (ConditionalSampler,  # noqa: E402
                                                 SampleResult)
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402
from diffndm_tpu_torch.models.adjust_net import (OPTAX_ADAM_LEAVES,  # noqa: E402
                                                 AdjustNet, AdjustNetState)
from diffndm_tpu_torch.structs import from_lists  # noqa: E402

ATOL, RTOL = 1e-6, 1e-5
T_STACK, NL, F = 6, 32, 13
ROWS = (3, 17, 48, 220)


def port_state_from(jstate, cfg=RLConfig()):
    state = AdjustNetState(cfg)
    state.module.load_state_dict(adjust_params_from_jax(
        jax.device_get(jstate.params)))
    return state


def assert_params_equal(state, jstate, atol=0.0, rtol=0.0):
    p = jstate.params["params"]
    for name in ("fc1", "fc2"):
        layer = getattr(state.module, name)
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(p[name]["kernel"]).T,
                                   atol=atol, rtol=rtol)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(p[name]["bias"]),
                                   atol=atol, rtol=rtol)


def test_optax_leaf_order_is_the_ports_constant():
    jstate = JaxAdjust(jcfg.RLConfig())
    paths = jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0]
    names = []
    for path, _ in paths:
        keys = [getattr(k, "name", getattr(k, "key", None)) for k in path]
        keys = [k for k in keys if isinstance(k, str) and k != "params"]
        names.append("/".join(keys))
    assert tuple(names) == OPTAX_ADAM_LEAVES
    # the leaves' shapes: count, then bias / kernel [in, out] per layer
    shapes = [tuple(np.shape(v)) for v in jax.tree.leaves(jstate.opt_state)]
    assert shapes == [(), (128,), (13, 128), (13,), (128, 13)] + \
        [(128,), (13, 128), (13,), (128, 13)]


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_equals_flax(seed):
    jstate = JaxAdjust(jcfg.RLConfig(), key=jax.random.PRNGKey(seed))
    state = port_state_from(jstate)
    z = np.random.default_rng(seed).normal(size=(3, 4, NL, F)).astype(
        np.float32)
    ref = np.asarray(jstate.apply_fn()(jnp.asarray(z)))
    with torch.no_grad():
        out = state.module(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not an AdjustNet"):
        adjust_params_from_jax({"params": {"fc3": {"kernel": np.zeros(2),
                                                   "bias": np.zeros(2)}}})


def rl_inputs(seed):
    """Real test ligands as the decoded batch (their sizes give the final
    masks), and seeded stacks [T, B, NL, F]."""
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    pairs = [ds[i] for i in ROWS]
    lig = from_lists([p.lig_coords for p in pairs],
                     [p.lig_one_hot for p in pairs], n_max=NL)
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T_STACK, len(ROWS), NL, F)).astype(np.float32)
    eps = rng.normal(size=z.shape).astype(np.float32)
    return lig, z, eps


def jax_rl_update(jstate, lig, z, eps, oracle):
    """The JAX package's ConditionalSampler.rl_update on a decoded batch;
    it reads only the sampler's config and oracle."""
    sampler = types.SimpleNamespace(cfg=jcfg.SampleConfig(), oracle=oracle)
    result = JaxResult(
        ligand=JaxBatch(*(jnp.asarray(a.numpy()) for a in lig)),
        pocket=None, avg_log_prob=jnp.zeros(()),
        rl_traj=(jnp.asarray(z), jnp.asarray(eps)))
    return JaxSampler.rl_update(sampler, jstate, result, None)


@pytest.mark.parametrize("scorer", ["native", "python"])
def test_three_rl_updates_equal_jax(scorer):
    lig, z, eps = rl_inputs(seed=5)
    jstate = JaxAdjust(jcfg.RLConfig(), key=jax.random.PRNGKey(3))
    state = port_state_from(jstate)
    joracle = JaxOracle(jax_params["crossdock_full"])
    sampler = ConditionalSampler(None, None, SampleConfig(),
                                 RewardOracle(dataset_params["crossdock_full"],
                                              scorer=scorer))
    result = SampleResult(ligand=lig, pocket=None, row_src=None,
                          avg_log_prob=torch.zeros(()),
                          rl_traj=(torch.from_numpy(z), torch.from_numpy(eps)))
    before = [p.detach().clone() for p in state.module.parameters()]
    for step in range(3):
        ref = jax_rl_update(jstate, lig, z, eps, joracle)
        out = sampler.rl_update(state, result)
        assert out[2] == ref[2] and ref[2] > 1.0      # the reward
        np.testing.assert_allclose(out[:2], ref[:2], rtol=RTOL, atol=ATOL)
        assert state.history[-1] == out
        assert_params_equal(state, jstate, atol=ATOL, rtol=RTOL)
    assert all(not torch.equal(a, b) for a, b in
               zip(before, state.module.parameters()))
    assert len(state.history) == 3


def test_zero_reward_moves_nothing():
    lig, z, eps = rl_inputs(seed=6)
    state = AdjustNetState(RLConfig())
    before = [p.detach().clone() for p in state.module.parameters()]
    loss, grad_norm = state.reinforce(torch.from_numpy(z),
                                      torch.from_numpy(eps), lig.mask, 0.0,
                                      0.1)
    assert loss == 0.0 and grad_norm == 0.0
    assert all(torch.equal(a, b) for a, b in
               zip(before, state.module.parameters()))


def adam_leaves(state):
    """The port's Adam state in the optax leaf order and layout."""
    out = []
    for leaf in OPTAX_ADAM_LEAVES:
        if leaf == "count":
            out.append(int(state.optimizer.state[
                state.module.fc1.weight]["step"]))
            continue
        moment, name, kind = leaf.split("/")
        layer = getattr(state.module, name)
        param = layer.weight if kind == "kernel" else layer.bias
        value = state.optimizer.state[param][
            {"mu": "exp_avg", "nu": "exp_avg_sq"}[moment]].numpy()
        out.append(value.T if kind == "kernel" else value)
    return out


def test_checkpoints_cross_load(tmp_path):
    lig, z, eps = rl_inputs(seed=7)
    joracle = JaxOracle(jax_params["crossdock_full"])
    # JAX -> port: two JAX updates, saved, loaded by the port
    jstate = JaxAdjust(jcfg.RLConfig(), key=jax.random.PRNGKey(1))
    for _ in range(2):
        jax_rl_update(jstate, lig, z, eps, joracle)
    path = str(tmp_path / "jax.npz")
    jstate.save(path)
    state = AdjustNetState(RLConfig(), generator=torch.Generator()
                           .manual_seed(9))
    state.load(path)
    assert_params_equal(state, jstate)
    leaves = adam_leaves(state)
    ref = jax.tree.leaves(jstate.opt_state)
    assert leaves[0] == int(ref[0]) == 2
    for a, b in zip(leaves[1:], ref[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    # one more update on each side from the loaded states: still equal
    sampler = ConditionalSampler(None, None, SampleConfig(),
                                 RewardOracle(dataset_params["crossdock_full"],
                                              scorer="python"))
    result = SampleResult(ligand=lig, pocket=None, row_src=None,
                          avg_log_prob=torch.zeros(()),
                          rl_traj=(torch.from_numpy(z), torch.from_numpy(eps)))
    sampler.rl_update(state, result)
    jax_rl_update(jstate, lig, z, eps, joracle)
    assert_params_equal(state, jstate, atol=ATOL, rtol=RTOL)
    # port -> JAX: the port's state after that update, saved, loaded by JAX
    path = str(tmp_path / "port.npz")
    state.save(path)
    back = JaxAdjust(jcfg.RLConfig(), key=jax.random.PRNGKey(4))
    back.load(path)
    assert_params_equal(state, back)
    ref = jax.tree.leaves(back.opt_state)
    assert int(ref[0]) == 3
    for a, b in zip(adam_leaves(state)[1:], ref[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and the port reloads its own file bit for bit
    again = AdjustNetState(RLConfig())
    again.load(path)
    for a, b in zip(again.module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(adam_leaves(again), adam_leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_fresh_state_saves_optax_init(tmp_path):
    """A state that never stepped saves count 0 and zero moments, which
    JAX loads as its own init; the port's init is seeded."""
    path = str(tmp_path / "fresh.npz")
    AdjustNetState(RLConfig()).save(path)
    back = JaxAdjust(jcfg.RLConfig())
    back.load(path)
    init = jax.tree.leaves(optax.adam(1e-3).init(back.params))
    for a, b in zip(jax.tree.leaves(back.opt_state), init):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    a, b = AdjustNetState(RLConfig()), AdjustNetState(RLConfig())
    assert all(torch.equal(p, q) for p, q in zip(a.module.parameters(),
                                                 b.module.parameters()))
    assert isinstance(a.module, AdjustNet)


def test_reference_pth_weights(tmp_path):
    """The reference implementation's .pth (adjust_net.* weights and a
    torch optimizer state): the weights load as in the JAX package."""
    net = AdjustNet()
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    path = str(tmp_path / "ref.pth")
    torch.save(dict({f"adjust_net.{k}": v for k, v in
                     net.state_dict().items()},
                    optimizer_state_dict=opt.state_dict()), path)
    state = AdjustNetState.load_torch_state_dict(path, RLConfig())
    ref = JaxAdjust.load_torch_state_dict(path, jcfg.RLConfig())
    assert_params_equal(state, ref)
    for a, b in zip(state.module.parameters(), net.parameters()):
        assert torch.equal(a, b)
