"""Weights and configuration carried from the JAX package into the port.

- The committed EMA export equals, leaf by leaf and bit for bit, the
  ``ema_params`` of the orbax checkpoint it was made from; so does the
  raw training-state export (params, ema_params and step) that the
  port's train CLI resumes from.
- ``params_from_jax`` fills every parameter of the port's EGNNDynamics
  exactly once, from a nested or a flat tree alike.
- The port's YAML reader and ``model_config_from_yaml`` agree with the
  JAX package's (PyYAML-based) ones on every committed config.
- A state dict under the reference implementation's names (made from
  the committed weights by the JAX package's ``export_state_dict``), as
  a raw dict and as a Lightning ``.ckpt``, loads into the port equal to
  ``params_from_jax`` of the committed tree.
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
from diffndm_tpu import convert as jconvert  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import (convert_state_dict,  # noqa: E402
                                       flatten_tree,
                                       load_reference_checkpoint,
                                       params_from_jax)
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402

RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
TRAIN_STATE = "diffndm_tpu_torch/assets/virtual_cond_v3b_last.npz"


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


def test_committed_train_state_equals_orbax_last():
    from diffndm_tpu_torch.train.trainer import load_train_state

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "export_v3b_train_state", "scripts/export_v3b_train_state.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    ref = export.restore(RUN)
    with np.load(TRAIN_STATE) as f:
        committed = {k: f[k] for k in f.files}
    assert sorted(committed) == sorted(ref)
    for k, v in ref.items():
        assert committed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(committed[k], v, err_msg=k)
    params, ema, step = load_train_state(TRAIN_STATE)
    assert step == int(ref["step"]) > 0
    with np.load(NPZ) as f:       # the EMA export of the same checkpoint
        assert sorted(ema) == sorted(f.files)
        for k in f.files:
            np.testing.assert_array_equal(ema[k], f[k])
    assert params_from_jax(params).keys() == params_from_jax(ema).keys()


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
    port = tcfg.model_config_from_yaml(raw)
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


@pytest.mark.parametrize("name", ["SPSAConfig", "ATPConfig", "RLConfig",
                                  "InpaintConfig"])
def test_guidance_config_defaults_equal_jax(name):
    """Field by field: the same names, in the same order, with the same
    defaults, so that a default changed on one side is caught."""
    ours = dataclasses.fields(getattr(tcfg, name))
    ref = dataclasses.fields(getattr(jcfg, name))
    assert [f.name for f in ours] == [f.name for f in ref]
    for a, b in zip(ours, ref):
        assert a.default == b.default, a.name
        assert type(a.default) is type(b.default), a.name


def test_sample_config_fields_equal_jax_where_ported():
    """The port's SampleConfig is the JAX one: what sampling, guidance
    (with the fan-out's own band tile), the RL adjustment, inpainting and
    the output filters read."""
    ref = {f.name: f for f in dataclasses.fields(jcfg.SampleConfig)}
    ours = dataclasses.fields(tcfg.SampleConfig)
    assert [f.name for f in ours] == ["n_samples", "timesteps", "spsa",
                                      "atp", "rl", "inpaint", "sanitize",
                                      "relax_iter",
                                      "largest_frag", "noise_scale",
                                      "fanout_row_tile",
                                      "lig_pad_multiple",
                                      "pocket_pad_multiple"]
    assert [f.name for f in ours] == [n for n in ref if n in
                                      {f.name for f in ours}]
    made, made_ref = tcfg.SampleConfig(), jcfg.SampleConfig()
    for f in ours:
        assert f.name in ref
        if dataclasses.is_dataclass(getattr(made, f.name)):
            assert dataclasses.asdict(getattr(made, f.name)) == \
                dataclasses.asdict(getattr(made_ref, f.name))
        else:
            assert getattr(made, f.name) == getattr(made_ref, f.name)
    assert not made.spsa.enabled and not made.atp.enabled
    assert not made.rl.enabled and not made.rl.train


def nested(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, leaf = k.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_reference_state_dict_loads_equal_to_params_from_jax(tmp_path):
    from diffndm_tpu_torch.model import DiffNDM

    mcfg = tcfg.model_config_from_yaml(
        tcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    jmcfg = jcfg.model_config_from_yaml(
        jcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    with np.load(NPZ) as f:
        tree = nested({k: f[k] for k in f.files})
    sd = jconvert.export_state_dict(tree, jmcfg)
    assert any(k.endswith("edge_mlp.0.weight") for k in sd)
    # the same flax-shaped tree as the JAX package's converter builds
    ours = flatten_tree(convert_state_dict(sd, mcfg))
    ref = jax_flat(jconvert.convert_state_dict(sd, jmcfg))
    assert sorted(ours) == sorted(ref) == sorted(flatten_tree(tree))
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    want = params_from_jax(tree)
    # a Lightning checkpoint: 'ddpm.' prefixes, other entries beside
    path = str(tmp_path / "reference.ckpt")
    torch.save({"state_dict": {f"ddpm.{k}": torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in sd.items()},
        "epoch": 3}, path)
    got = load_reference_checkpoint(path, mcfg)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = DiffNDM(mcfg, device="cpu")
    model.load_reference_checkpoint(path)
    state = model.dynamics.state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)
