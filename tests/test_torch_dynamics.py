"""The port's EGNNDynamics forward against the JAX EGNNDynamics.apply on
the same parameters, converted by convert.params_from_jax.

(a) small width, random JAX init; (b) full v3b width with the committed
EMA weights on two processed test pockets, against both the JAX default
(XLA) path and its Pallas path in interpret mode.  Both sides run fp32;
five layers of sums taken in another order give the tolerance of
rtol 1e-4, atol 1e-5 (as tests/test_pallas_kernels.py uses for the
Pallas-vs-XLA comparison).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
RUN = "examples/checkpoints/virtual_cond_v3b"
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
TEST_NPZ = "data/processed/virtual_v3/test.npz"


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def port_dynamics(egnn_cfg, atom_nf, residue_nf, jax_params):
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax_params)[0]}
    model = EGNNDynamics(egnn_cfg, atom_nf, residue_nf)
    model.load_state_dict(params_from_jax(flat), strict=True)
    return model.eval()


def run_port(model, xh_lig, xh_poc, t, lm, pm):
    with torch.no_grad():
        el, ep = model(*[torch.from_numpy(np.asarray(v))
                         for v in (xh_lig, xh_poc, t, lm, pm)])
    return el.numpy(), ep.numpy()


def test_small_width_random_init():
    rng = np.random.default_rng(0)
    atom_nf = residue_nf = 10
    jc = jcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2,
                         edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
    module = JaxDynamics(jc, atom_nf=atom_nf, residue_nf=residue_nf)
    b, nl, npk = 3, 8, 24
    lm = np.ones((b, nl), np.float32)
    lm[1, 5:] = 0
    lm[2, 3:] = 0
    pm = np.ones((b, npk), np.float32)
    pm[0, 20:] = 0
    xh_lig = rng.normal(size=(b, nl, 3 + atom_nf)).astype(np.float32) * \
        lm[..., None]
    xh_poc = (rng.normal(size=(b, npk, 3 + residue_nf)) * 2).astype(
        np.float32) * pm[..., None]
    t = np.array([0.1, 0.5, 0.9], np.float32)
    params = jax.jit(module.init)(jax.random.PRNGKey(3), xh_lig, xh_poc, t,
                                  lm, pm)
    ref = jax.jit(module.apply)(params, xh_lig, xh_poc, t, lm, pm)
    tc = tcfg.EGNNConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(tcfg.EGNNConfig)})
    out = run_port(port_dynamics(tc, atom_nf, residue_nf, params), xh_lig,
                   xh_poc, t, lm, pm)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def v3b_batch():
    """Two real test pockets with their ligands (normalised like the
    sampler's z: x / 1, one-hot / 4), padded to a common size, B = 2."""
    ds = ProcessedLigandPocketDataset(TEST_NPZ)
    pairs = [ds[0], ds[5]]
    nf = 10
    nl = -(-max(len(p.lig_coords) for p in pairs) // 8) * 8
    npk = -(-max(len(p.pocket_coords) for p in pairs) // 16) * 16
    xh_lig = np.zeros((2, nl, 3 + nf), np.float32)
    xh_poc = np.zeros((2, npk, 3 + nf), np.float32)
    lm = np.zeros((2, nl), np.float32)
    pm = np.zeros((2, npk), np.float32)
    rng = np.random.default_rng(1)
    for i, p in enumerate(pairs):
        n, m = len(p.lig_coords), len(p.pocket_coords)
        xh_lig[i, :n, :3] = p.lig_coords + rng.normal(size=(n, 3)) * 0.3
        xh_lig[i, :n, 3:] = p.lig_one_hot[:, :nf] / 4.0
        xh_poc[i, :m, :3] = p.pocket_coords
        xh_poc[i, :m, 3:] = p.pocket_one_hot[:, :nf] / 4.0
        lm[i, :n] = 1
        pm[i, :m] = 1
    t = np.array([0.3, 0.8], np.float32)
    return xh_lig, xh_poc, t, lm, pm


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_full_width_v3b_ema(v3b_batch, pallas):
    raw_j = jcfg.load_yaml(os.path.join(RUN, "hparams.yaml"))
    mj = jcfg.model_config_from_yaml(raw_j)
    mt = tcfg.model_config_from_yaml(
        tcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    assert (mt.egnn.hidden_nf, mt.egnn.n_layers) == (192, 5)
    egnn = dataclasses.replace(mj.egnn, use_pallas=pallas,
                               pallas_interpret=pallas)
    with np.load(NPZ) as f:
        params = unflatten({k: f[k] for k in f.files})
    apply = jax.jit(JaxDynamics(egnn, atom_nf=mj.atom_nf,
                                residue_nf=mj.residue_nf).apply)
    ref = apply(params, *v3b_batch)
    model = port_dynamics(mt.egnn, mt.atom_nf, mt.residue_nf, params)
    out = run_port(model, *v3b_batch)
    for o, r in zip(out, ref):
        assert np.all(np.isfinite(o))
        np.testing.assert_allclose(o, np.asarray(r), rtol=RTOL, atol=ATOL)
