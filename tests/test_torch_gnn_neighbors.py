"""The port's GNN denoiser under K-nearest-neighbour edges.

``EGNNDynamics(mode="gnn_dynamics", neighbors=K)`` keeps, row by row, the
K best-ranked columns of the cutoff graph (``egnn.neighbor_mask``) and runs
the plain GNN over the remaining dense adjacency.  The JAX package cannot
serve as the reference here: its GNN cannot run with K-NN (it hands the
gathered [B, N, K] lists to a GNN that takes a dense [B, N, N] adjacency;
ROADMAP Queue C).  So the forward is held to the port's own dense GNN on
the same weights, run on the adjacency times a neighbour mask built by
hand in the test, to the bit; and it is told apart from the dense GNN
without the mask, where K is below the degree of many rows.  Two
configurations: no edge features, and an edge-type embedding (whose
features the selection must follow).

Torch runs on one thread around its ops (the ROADMAP's ground rules).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.models import dynamics as dyn  # noqa: E402
from diffndm_tpu_torch.models.egnn import neighbor_mask  # noqa: E402

ATOM_NF = RESIDUE_NF = 10
B, NL, NP = 2, 8, 32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(seed, spread=2.5):
    """A ligand inside a pocket whose atoms spread ``spread`` A from its
    centre (the default 2.5 with 5 A cutoffs gives most rows more edges
    than K); the second row has padding in both blocks."""
    rng = np.random.default_rng(seed)
    lm = np.ones((B, NL), np.float32)
    lm[1, 6:] = 0
    pm = np.ones((B, NP), np.float32)
    pm[1, 28:] = 0
    x_lig = rng.normal(size=(B, NL, 3)) * 1.2
    x_poc = rng.normal(size=(B, NP, 3)) * spread
    h_lig = rng.normal(size=(B, NL, ATOM_NF))
    h_poc = rng.normal(size=(B, NP, RESIDUE_NF))
    xh_lig = (np.concatenate([x_lig, h_lig], -1) * lm[..., None])
    xh_poc = (np.concatenate([x_poc, h_poc], -1) * pm[..., None])
    t = np.array([0.3, 0.8], np.float32)
    return [torch.from_numpy(np.asarray(v, np.float32))
            for v in (xh_lig, xh_poc, t, lm, pm)]


def gnn(seed, **kw):
    cfg = tcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2,
                          mode="gnn_dynamics", **kw)
    torch.manual_seed(seed)
    return dyn.EGNNDynamics(cfg, ATOM_NF, RESIDUE_NF).eval()


def dense_with_mask(model, args, k, monkeypatch):
    """The dense GNN of ``model``'s weights on adj * a neighbour mask built
    here from the joint coordinates and the cutoff adjacency."""
    dense = gnn(0, **{f.name: getattr(model.cfg, f.name)
                      for f in dataclasses.fields(tcfg.EGNNConfig)
                      if f.name not in ("neighbors", "mode", "hidden_nf",
                                        "joint_nf", "n_layers")})
    dense.load_state_dict(model.state_dict())
    assert dense.cfg.neighbors is None
    built = dyn.build_adjacency
    masks = []

    def masked(x_lig, x_poc, lig_mask, pocket_mask, cfg):
        adj = built(x_lig, x_poc, lig_mask, pocket_mask, cfg)
        keep = neighbor_mask(torch.cat([x_lig, x_poc], 1), adj,
                             x_lig.shape[1], k)
        masks.append((adj, keep))
        return adj * keep
    monkeypatch.setattr(dyn, "build_adjacency", masked)
    with torch.no_grad():
        out = dense(*args)
    monkeypatch.setattr(dyn, "build_adjacency", built)
    return out, masks[0]


@pytest.mark.parametrize("edge_embedding_dim", [None, 8])
@pytest.mark.parametrize("k", [6, 12])
def test_gnn_knn_equals_dense_gnn_on_the_masked_adjacency(
        k, edge_embedding_dim, monkeypatch):
    args = inputs(k)
    model = gnn(1, neighbors=k, edge_embedding_dim=edge_embedding_dim)
    with torch.no_grad():
        got = model(*args)
    want, (adj, keep) = dense_with_mask(model, args, k, monkeypatch)
    # K is below the degree of many rows: the selection dropped edges
    degree = adj.sum(-1)
    assert int((degree > k).sum()) > B * (NL + NP) // 2
    assert int((adj * (1 - keep)).sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and it is apart from the dense GNN without the mask
    dense = gnn(1, edge_embedding_dim=edge_embedding_dim)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        full = dense(*args)
    assert max(float((g - f).abs().max()) for g, f in zip(got, full)) > 1e-3


def test_gnn_knn_at_the_degree_keeps_every_edge():
    """With K at every row's count of boosted columns (its edges, and in a
    ligand row the ligand slots) the mask keeps every edge, and the
    forward equals the dense GNN's."""
    args = inputs(3, spread=6.0)
    adj = dyn.build_adjacency(args[0][..., :3], args[1][..., :3], args[3],
                              args[4], gnn(2).cfg)
    ll = (torch.arange(NL + NP) < NL).float()
    boosted = ((adj + ll[:, None] * ll[None, :]) > 0).sum(-1)
    k = int(boosted.max())
    assert k < NL + NP                     # the mask is applied
    model = gnn(2, neighbors=k)
    dense = gnn(2)
    dense.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, want = model(*args), dense(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
