"""K-nearest-neighbour edges (``EGNNConfig.neighbors``) against the JAX
package's gathered neighbour lists.

- ``egnn.neighbor_mask`` selects, row by row, the same columns as JAX's
  ``build_neighbor_lists`` (as sets), on inputs built to tie: a cluster
  of atoms within about 1.5 A of each other, where every pair is an edge
  and the float32 score -d2 + 1e7 has a spacing of 1 (2 above 2e7), so
  that most real edges tie and only the tie-break decides;
- with K at least every row's count of boosted columns (its edges, and in
  a ligand row the padded ligand slots, which the ligand-clique boost ranks
  with the edges, in JAX as here), the forward equals the dense one;
- with K below the degree of many rows, the forward equals JAX's gathered
  forward on the same weights (sums over the same edges in another order:
  rtol 1e-4, atol 1e-5, as the fp32 forwards) and lies beyond that from
  the dense forward.  Three configurations: the kernels' path, ``mean``
  aggregation (the degree is the selected count) and an edge-type
  embedding (its features follow the selection).

Torch runs on one thread around its ops (the ROADMAP's ground rules).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.models.egnn import build_neighbor_lists  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.models.dynamics import build_adjacency  # noqa: E402
from diffndm_tpu_torch.models.egnn import neighbor_mask  # noqa: E402
from test_torch_dynamics import port_dynamics  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ATOM_NF = RESIDUE_NF = 10
B, NL, NP = 2, 8, 40


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [5, 12, 15])
def test_selection_equals_jax_lists_on_ties(k):
    rng = np.random.default_rng(0)
    n, nl = 36, 6
    x = (rng.uniform(size=(B, n, 3)) * 1.5).astype(np.float32)
    # a second, spread-out cluster so that rows have non-edges too
    x[:, n // 2:] += np.array([6.0, 0.0, 0.0], np.float32)
    x[:, n // 2:] += rng.normal(size=(B, n - n // 2, 3)).astype(
        np.float32) * 1.5
    adj = (((x[:, :, None] - x[:, None]) ** 2).sum(-1) <= 9.0).astype(
        np.float32)
    is_lig = (np.arange(n) < nl).astype(np.float32)
    idx, _ = build_neighbor_lists(jnp.asarray(x), jnp.asarray(adj),
                                  jnp.asarray(is_lig), k)
    idx = np.asarray(idx)
    mask = neighbor_mask(torch.from_numpy(x), torch.from_numpy(adj), nl,
                         k).numpy()
    assert (mask.sum(-1) == k).all()
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    score = (-d2 + 1e7 * adj + 1e7 * is_lig[:, None] * is_lig[None])
    score = score.astype(np.float32)
    for b in range(B):
        for i in range(n):
            assert set(np.flatnonzero(mask[b, i])) == set(idx[b, i]), (b, i)
    # the K-th and the (K+1)-th best scores tie: the tie-break decided
    ranked = -np.sort(-score, axis=-1)
    assert (ranked[..., k - 1] == ranked[..., k]).sum() > 20


def inputs(seed, npk=NP):
    rng = np.random.default_rng(seed)
    lm = np.ones((B, NL), np.float32)
    lm[1, 6:] = 0
    pm = np.ones((B, npk), np.float32)
    pm[0, npk - 4:] = 0
    xh_lig = rng.normal(size=(B, NL, 3 + ATOM_NF)).astype(np.float32) * \
        lm[..., None]
    xh_poc = np.concatenate(
        [rng.normal(size=(B, npk, 3)) * 2.5,
         rng.normal(size=(B, npk, RESIDUE_NF))], -1).astype(
        np.float32) * pm[..., None]
    return xh_lig, xh_poc, np.array([0.3, 0.8], np.float32), lm, pm


def boosted_columns(xh_lig, xh_poc, lm, pm, cfg):
    """The most columns any row ranks above its non-edges: its edges, and
    in a ligand row every ligand slot (padding too)."""
    adj = build_adjacency(*(torch.from_numpy(v) for v in (
        xh_lig[..., :3], xh_poc[..., :3], lm, pm)), cfg)
    lig = torch.arange(adj.shape[-1]) < NL
    boosted = adj.bool() | (lig[:, None] & lig[None, :])
    return int(boosted.sum(-1).max())


def forwards(jc, seed):
    """(port forward with neighbors, port dense forward, JAX forward with
    neighbors) on JAX's random init."""
    data = inputs(seed)
    module = JaxDynamics(jc, atom_nf=ATOM_NF, residue_nf=RESIDUE_NF)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *data)
    ref = jax.jit(module.apply)(params, *data)
    tc = tcfg.EGNNConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(tcfg.EGNNConfig)})
    knn = port_dynamics(tc, ATOM_NF, RESIDUE_NF, params)
    dense = port_dynamics(dataclasses.replace(tc, neighbors=None), ATOM_NF,
                          RESIDUE_NF, params)
    args = [torch.from_numpy(v) for v in data]
    with torch.no_grad():
        return ([o.numpy() for o in knn(*args)],
                [o.numpy() for o in dense(*args)],
                [np.asarray(r) for r in ref])


def small_config(**kw):
    return jcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2,
                           edge_cutoff_pocket=4.0,
                           edge_cutoff_interaction=4.0, **kw)


def test_k_at_least_every_degree_equals_dense():
    data = inputs(1)
    cfg = tcfg.EGNNConfig(edge_cutoff_pocket=4.0,
                          edge_cutoff_interaction=4.0)
    k = boosted_columns(data[0], data[1], data[3], data[4], cfg)
    assert k < NL + NP
    knn, dense, ref = forwards(small_config(neighbors=k), 1)
    for o, d, r in zip(knn, dense, ref):
        np.testing.assert_allclose(o, d, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", [
    {}, {"aggregation_method": "mean"}, {"edge_embedding_dim": 4}])
def test_k_below_the_degree_equals_jax(variant):
    data = inputs(2)
    cfg = tcfg.EGNNConfig(edge_cutoff_pocket=4.0,
                          edge_cutoff_interaction=4.0)
    adj = build_adjacency(*(torch.from_numpy(v) for v in (
        data[0][..., :3], data[1][..., :3], data[3], data[4])), cfg)
    k = 10
    # many rows have more edges than K (the ligand clique alone has 8)
    assert (adj.sum(-1) > k).float().mean() > 0.2
    knn, dense, ref = forwards(small_config(neighbors=k, **variant), 2)
    for o, r in zip(knn, ref):
        np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL)
    far = max(np.abs(o - d).max() / (ATOL + RTOL * np.abs(d).max())
              for o, d in zip(knn, dense))
    assert far > 10.0, far
