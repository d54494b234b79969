"""The port's joint-model loss terms against the JAX package's.

``joint_loss_terms`` on four complexes of the virtual validation set,
through a small joint denoiser (2 layers, hidden 32,
``update_pocket_coords``) on the same weights, fed the timesteps and
noise JAX drew from its key: every term within rtol 1e-5 (atol 1e-5), in
training and in eval.  Then the gradient of a scalar of the terms with
respect to every parameter, through the plain path (autograd through the
wrappers' plain backward), against ``jax.grad``: each tensor within
1e-5 + 1e-4 of its largest entry, as tests/test_torch_losses.py holds the
conditional loss.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.data.dataset import (  # noqa: E402
    ProcessedLigandPocketDataset as JDataset, collate_padded as jcollate)
from diffndm_tpu.diffusion import joint as jjoint  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.train import losses as jlosses  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from diffndm_tpu_torch.diffusion import joint as tjoint  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train import losses as tlosses  # noqa: E402
from test_torch_joint import jax_joint_draw  # noqa: E402

T = 50
NF = 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0,
            update_pocket_coords=True)
# the scalar whose gradient is compared: every term that depends on the
# denoiser
GRAD_TERMS = ("error_t_lig", "error_t_pocket", "loss_0_x", "loss_0_x_pocket")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    ds = JDataset(DATA)
    jlig, jpoc = jcollate([ds[i] for i in (3, 20, 40, 60)],
                          drop_feature_cols=1)
    module = JaxDynamics(jcfg.EGNNConfig(**EGNN), atom_nf=NF, residue_nf=NF)
    params = jax.jit(module.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 3 + NF)),
        jnp.zeros((1, 16, 3 + NF)), jnp.zeros((1,)), jnp.ones((1, 8)),
        jnp.ones((1, 16)))
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    dyn.load_state_dict(params_from_jax(params))
    jcore = jjoint.JointDiffusion(jS.make_schedule("polynomial_2", T, 5e-4),
                                  jcfg.DiffusionConfig(timesteps=T), NF, NF)
    tcore = tjoint.JointDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                                  tcfg.DiffusionConfig(timesteps=T), NF, NF)
    to_t = (lambda nb: NodeBatch(*(torch.from_numpy(np.array(a))
                                   for a in nb)))
    return dict(jlig=jlig, jpoc=jpoc, module=module, params=params, dyn=dyn,
                jcore=jcore, tcore=tcore, lig=to_t(jlig), poc=to_t(jpoc))


def jax_draws(key, jlig, jpoc, training):
    """The timesteps and joint draws JAX's joint_loss_terms makes."""
    k_t, k_noise, k_noise0 = jax.random.split(key, 3)
    b, nl = jlig.mask.shape
    npk = jpoc.mask.shape[1]
    t_int = jax.random.randint(k_t, (b,), 0 if training else 1, T + 1)
    return (torch.from_numpy(np.array(t_int, np.float32)),
            jax_joint_draw(k_noise, b, nl, npk),
            jax_joint_draw(k_noise0, b, nl, npk))


def close(name, out, ref):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_ref(setup):
    """Per training mode: JAX's terms, and the value and gradient of the
    scalar of GRAD_TERMS, from one jitted ``jax.value_and_grad`` on the
    key PRNGKey(17 + training)."""
    jcore, module = setup["jcore"], setup["module"]
    out = {}
    for training in (True, False):
        def jloss(params, key, training=training):
            terms = jlosses.joint_loss_terms(
                key, jcore, lambda zl, zp, t, lm, pm: module.apply(
                    params, zl, zp, t, lm, pm),
                setup["jlig"], setup["jpoc"], training)
            return sum(terms[k].mean() for k in GRAD_TERMS), terms

        key = jax.random.PRNGKey(17 + training)
        (value, terms), grads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(setup["params"], key)
        out[training] = dict(key=key, value=value, terms=terms, grads=grads)
    return out


@pytest.mark.parametrize("training", [True, False],
                         ids=["training", "eval"])
def test_joint_loss_terms_equal_jax(setup, jax_ref, training):
    ref = jax_ref[training]
    jterms = ref["terms"]
    with torch.no_grad():
        tterms = tlosses.joint_loss_terms(
            setup["tcore"], setup["dyn"], setup["lig"], setup["poc"],
            training, *jax_draws(ref["key"], setup["jlig"], setup["jpoc"],
                                 training))
    assert sorted(tterms) == sorted(jterms)
    for k in jterms:
        close(k, tterms[k], jterms[k])
    # the pocket is denoised too: its error is not zero
    assert float(tterms["error_t_pocket"].max()) > 0 or not training


@pytest.mark.parametrize("training", [True, False],
                         ids=["training", "eval"])
def test_joint_loss_gradients_equal_jax_grad(setup, jax_ref, training):
    ref = jax_ref[training]
    jvalue, jgrads = ref["value"], ref["grads"]
    dyn = setup["dyn"]
    names, params = zip(*dyn.named_parameters())
    draws = jax_draws(ref["key"], setup["jlig"], setup["jpoc"], training)
    with torch.enable_grad():
        terms = tlosses.joint_loss_terms(setup["tcore"], dyn, setup["lig"],
                                         setup["poc"], training, *draws)
        value = sum(terms[k].mean() for k in GRAD_TERMS)
        grads = torch.autograd.grad(value, params, allow_unused=True)
    np.testing.assert_allclose(float(value.detach()), float(jvalue),
                               rtol=1e-5)
    ours = params_to_jax({n: (torch.zeros_like(p) if g is None else g)
                          for n, p, g in zip(names, params, grads)})
    ref = {"params/" + "/".join(str(k.key) for k in path[1:]): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        err = float(np.abs(ours[k] - r).max())
        assert err <= 1e-5 + 1e-4 * float(np.abs(r).max()), (k, err)
    # joint mode: the pocket's decoder is trained
    assert all(float(np.abs(v).max()) > 0 for k, v in ref.items()
               if "residue_decoder" in k and "kernel" in k)
