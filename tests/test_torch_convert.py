"""Weights and configuration carried from the JAX package into the port.

- The committed EMA export equals, leaf by leaf and bit for bit, the
  ``ema_params`` of the orbax checkpoint it was made from.
- ``params_from_jax`` fills every parameter of the port's EGNNDynamics
  exactly once, from a nested or a flat tree alike.
- The port's YAML reader and ``model_config_from_yaml`` agree with the
  JAX package's (PyYAML-based) ones on every committed config.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import flatten_tree, params_from_jax  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"


def jax_flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_committed_npz_equals_orbax_ema_params():
    import orbax.checkpoint as ocp

    mcfg = jcfg.model_config_from_yaml(
        jcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    module = JaxDynamics(mcfg.egnn, atom_nf=mcfg.atom_nf,
                         residue_nf=mcfg.residue_nf)
    # the tree's shapes suffice as the restore target
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 3 + mcfg.atom_nf)),
                            jnp.zeros((1, 16, 3 + mcfg.residue_nf)),
                            jnp.zeros((1,)), jnp.ones((1, 8)),
                            jnp.ones((1, 16)))
    restored = ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(RUN, "last")),
        {"params": shapes, "step": 0, "ema_params": shapes})
    ema = jax_flat(restored["ema_params"])
    with np.load(NPZ) as f:
        committed = {k: f[k] for k in f.files}
    assert sorted(committed) == sorted(ema)
    for k, v in ema.items():
        assert committed[k].dtype == np.float32
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    # the export holds the EMA weights, not the raw ones
    raw = jax_flat(restored["params"])
    assert any(not np.array_equal(raw[k], ema[k]) for k in ema)


def test_params_from_jax_covers_every_parameter_once():
    mcfg = tcfg.model_config_from_yaml(
        tcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    model = EGNNDynamics(mcfg.egnn, mcfg.atom_nf, mcfg.residue_nf)
    with np.load(NPZ) as f:
        flat = {k: f[k] for k in f.files}
    state = params_from_jax(flat)
    expected = model.state_dict()
    assert len(state) == len(flat)
    assert sorted(state) == sorted(expected)
    for k, v in expected.items():
        assert state[k].shape == v.shape, k
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.size for v in flat.values())
    # a nested tree converts to the same state
    nested = {}
    for k, v in flat.items():
        node = nested
        *head, leaf = k.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    assert flatten_tree(nested).keys() == flat.keys()
    again = params_from_jax(nested)
    assert all(torch.equal(again[k], state[k]) for k in state)
    # flax kernels are [in, out]; nn.Linear weights are [out, in]
    np.testing.assert_array_equal(
        state["atom_encoder_l0.weight"].numpy(),
        flat["params/atom_encoder_l0/kernel"].T)


CONFIGS = sorted(glob.glob("configs/*.yml")) + [
    os.path.join(RUN, "hparams.yaml")]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_and_model_config_match(path):
    with open(path) as f:
        text = f.read()
    raw = yaml.safe_load(text)
    assert tcfg.parse_yaml(text) == raw
    try:
        port = tcfg.model_config_from_yaml(raw)
    except ValueError as e:
        # the port carries only the full-atom CrossDocked encoding
        assert "not supported by the port" in str(e)
        assert jcfg.model_config_from_yaml(raw).dataset != "crossdock_full"
        return
    ref = jcfg.model_config_from_yaml(raw)
    for name in ("dataset", "mode", "pocket_representation", "atom_nf",
                 "residue_nf", "n_dims"):
        assert getattr(port, name) == getattr(ref, name), name
    for f in dataclasses.fields(port.egnn):
        assert getattr(port.egnn, f.name) == getattr(ref.egnn, f.name), \
            f.name
    for f in dataclasses.fields(port.diffusion):
        assert getattr(port.diffusion, f.name) == \
            getattr(ref.diffusion, f.name), f.name
