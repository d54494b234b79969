"""The sorted band (``EGNNConfig.band_window``) against the JAX package's.

- ``principal_axis_order`` and ``band_halfwidth_atoms`` equal JAX's (the
  order, to the element; the projections to float32 rounding), also where
  the eigenvector's sign decides the order;
- ``band_mask`` keeps exactly the (row, column) pairs of JAX's head and
  band contexts (``make_edge_contexts``), read back from an adjacency that
  encodes each pair;
- the denoiser, on JAX's ``tests/test_banding.py`` inputs (an elongated
  48-atom pocket, row tile 8): an exact window equals the dense forward,
  both the port's and JAX's; an approximate window (16 columns, under the
  exact bound) equals JAX's banded forward and lies away from the dense
  one; joint mode (every row moving, the zero-COM projection in the
  caller's order) equals JAX's banded joint forward.  Sums over the same
  edges in another order: rtol 1e-4, atol 1e-5, as the fp32 forwards;
- the facade: ``enable_banding`` (with ``DIFFNDM_BAND_APPROX`` unset,
  empty and 32) and ``ensure_band_for`` (an easy pocket, a hard one, the
  easy one again) pick JAX's windows on the pockets of JAX's tests, and
  ``generate_ligands`` bands a large pocket by default, prints its
  ``[banding] window=`` line and honours ``DIFFNDM_AUTO_BAND=0`` and
  ``DIFFNDM_BAND_APPROX``.  The denoiser runs the band only under a
  capped window: under an exact one the result is the band-off run's, to
  the bit.

Torch runs on one thread around its ops (the ROADMAP's ground rules).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.model import DiffNDM as JaxDiffNDM  # noqa: E402
from diffndm_tpu.models import banding as jband  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.models.egnn import make_edge_contexts  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxNodeBatch  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.model import DiffNDM  # noqa: E402
from diffndm_tpu_torch.models import banding  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from test_torch_dynamics import port_dynamics  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
FEAT = 6
B, NL, NP = 2, 8, 48
TILE = 8


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def protein_like_pocket(rng, b, n, stretch=6.0):
    """JAX's tests/test_banding.py pocket: elongated along x."""
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    x[..., 0] *= stretch
    x[..., 1:] *= 2.0
    return x


@pytest.mark.parametrize("seed", range(6))
def test_principal_axis_order_equals_jax(seed):
    rng = np.random.default_rng(seed)
    x = protein_like_pocket(rng, 3, 40, stretch=(6.0, 1.5)[seed % 2])
    mask = np.ones((3, 40), np.float32)
    mask[0, 31:] = 0
    mask[2, 5:9] = 0
    order, proj = jband.principal_axis_order(jnp.asarray(x),
                                             jnp.asarray(mask))
    t_order, t_proj = banding.principal_axis_order(torch.from_numpy(x),
                                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
    np.testing.assert_allclose(t_proj.numpy(), np.asarray(proj), rtol=1e-5,
                               atol=1e-5)
    # padding sorts last
    taken = np.take_along_axis(mask, t_order.numpy(), axis=1)
    assert (np.diff(taken, axis=1) <= 0).all()


@pytest.mark.parametrize("stretch", [14.0, 6.0, 2.0])
def test_band_halfwidth_equals_jax(stretch):
    rng = np.random.default_rng(2)
    x = protein_like_pocket(rng, 2, 64, stretch)
    m = np.ones((2, 64), np.float32)
    m[1, 50:] = 0
    for cutoff in (5.0, 8.0):
        assert banding.band_halfwidth_atoms(x, m, cutoff) == \
            jband.band_halfwidth_atoms(x, m, cutoff)


@pytest.mark.parametrize("n_lig,window", [(8, 16), (5, 24), (13, 8),
                                          (8, 39)])
def test_band_mask_equals_jax_contexts(n_lig, window):
    n = n_lig + 48
    cfg = jcfg.EGNNConfig(row_tile=TILE, band_window=window)
    code = (np.arange(n)[:, None] * n + np.arange(n)[None, :] + 1).astype(
        np.float32)
    adj = jnp.asarray(np.broadcast_to(code, (1, n, n)))
    x = jnp.zeros((1, n, 3))
    ctxs = make_edge_contexts(cfg, x, adj, jnp.zeros((1, n, n, 1)), None,
                              n_lig=n_lig)
    assert len(ctxs) == 2
    pairs = set()
    for ctx in ctxs:
        for i0 in np.asarray(ctx.row_i0s):
            for v in np.asarray(ctx.adj_rows(int(i0))).ravel():
                if v > 0:
                    pairs.add(divmod(int(v) - 1, n))
    mask = banding.band_mask(n, n_lig, TILE, window, "cpu").numpy()
    assert set(zip(*np.nonzero(mask))) == pairs


@pytest.fixture(scope="module")
def inputs():
    """JAX's tests/test_banding.py inputs."""
    rng = np.random.default_rng(0)
    xh_lig = rng.normal(size=(B, NL, 3 + FEAT)).astype(np.float32)
    xh_poc = np.concatenate(
        [protein_like_pocket(rng, B, NP),
         rng.normal(size=(B, NP, FEAT)).astype(np.float32)], -1)
    t = np.array([0.3, 0.7], np.float32)
    lm = (np.arange(NL)[None] < np.array([[6], [8]])).astype(np.float32)
    pm = (np.arange(NP)[None] < np.array([[40], [48]])).astype(np.float32)
    return xh_lig, xh_poc, t, lm, pm


def exact_window(xh_poc, pm):
    hw = banding.band_halfwidth_atoms(xh_poc[..., :3], pm, 5.0)
    return min(2 * hw + TILE + 2, NP - 1)


def forwards(inputs, jc, band_window):
    """(port banded, port dense, JAX banded, JAX dense) forwards on JAX's
    random init."""
    banded_j = dataclasses.replace(jc, band_window=band_window)
    dense_m = JaxDynamics(jc, atom_nf=FEAT, residue_nf=FEAT)
    params = jax.jit(dense_m.init)(jax.random.PRNGKey(0), *inputs)
    ref_dense = jax.jit(dense_m.apply)(params, *inputs)
    ref_band = jax.jit(JaxDynamics(banded_j, atom_nf=FEAT,
                                   residue_nf=FEAT).apply)(params, *inputs)
    tc = tcfg.EGNNConfig(**{f.name: getattr(banded_j, f.name)
                            for f in dataclasses.fields(tcfg.EGNNConfig)})
    band = port_dynamics(tc, FEAT, FEAT, params)
    dense = port_dynamics(dataclasses.replace(tc, band_window=None), FEAT,
                          FEAT, params)
    args = [torch.from_numpy(v) for v in inputs]
    with torch.no_grad():
        return ([o.numpy() for o in band(*args)],
                [o.numpy() for o in dense(*args)],
                [np.asarray(r) for r in ref_band],
                [np.asarray(r) for r in ref_dense])


def config(**kw):
    return jcfg.EGNNConfig(hidden_nf=16, joint_nf=8, n_layers=2,
                           inv_sublayers=1, attention=True, tanh=True,
                           edge_cutoff_pocket=5.0,
                           edge_cutoff_interaction=5.0, row_tile=TILE, **kw)


def all_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def distance(got, want):
    """The largest share of the tolerance any element uses."""
    return max(float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("reflection", [True, False])
def test_exact_window_equals_dense(inputs, reflection):
    w = exact_window(inputs[1], inputs[4])
    assert w < NP
    band, dense, ref_band, ref_dense = forwards(
        inputs, config(reflection_equivariant=reflection), w)
    all_close(band, dense)
    all_close(band, ref_dense)
    all_close(band, ref_band)


def test_approximate_window_equals_jax_banded(inputs):
    """16 columns against an exact bound of about 30: real edges are
    dropped, the same ones as in JAX (the order and the windows agree).
    Seen: up to ~1e4 times the tolerance away from the dense forward."""
    assert exact_window(inputs[1], inputs[4]) > 16 + TILE
    band, dense, ref_band, _ = forwards(inputs, config(), 16)
    all_close(band, ref_band)
    assert distance(band, dense) > 100.0


def test_joint_mode_with_the_band_equals_jax(inputs):
    band, dense, ref_band, ref_dense = forwards(
        inputs, config(update_pocket_coords=True), 16)
    all_close(band, ref_band)
    w = exact_window(inputs[1], inputs[4])
    band, dense, _, _ = forwards(inputs, config(update_pocket_coords=True),
                                 w)
    all_close(band, dense)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def tiny_configs():
    egnn = dict(hidden_nf=16, joint_nf=8, n_layers=1, inv_sublayers=1,
                attention=False, reflection_equivariant=True, row_tile=8)
    return (jcfg.ModelConfig(egnn=jcfg.EGNNConfig(**egnn),
                             diffusion=jcfg.DiffusionConfig(timesteps=6)),
            tcfg.ModelConfig(egnn=tcfg.EGNNConfig(**egnn),
                             diffusion=tcfg.DiffusionConfig(timesteps=6)))


@pytest.fixture(scope="module")
def models():
    jc, tc = tiny_configs()
    return JaxDiffNDM(jc), DiffNDM(tc, device="cpu")


def pockets(seed, stretch, b=2, n=128):
    """A pocket of JAX's facade tests for both packages."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    x[..., 0] *= stretch
    x[..., 1:] *= 2.0
    h = np.eye(10, dtype=np.float32)[rng.integers(0, 4, (b, n))]
    mask = np.ones((b, n), np.float32)
    return (JaxNodeBatch(jnp.asarray(x), jnp.asarray(h), jnp.asarray(mask)),
            NodeBatch(torch.from_numpy(x), torch.from_numpy(h),
                      torch.from_numpy(mask)))


def test_enable_banding_picks_jax_windows(models, monkeypatch):
    jm, tm = models
    runs = set()
    for approx in (None, "", "32"):
        if approx is None:
            monkeypatch.delenv("DIFFNDM_BAND_APPROX", raising=False)
        else:
            monkeypatch.setenv("DIFFNDM_BAND_APPROX", approx)
        for seed, stretch in ((5, 12.0), (6, 12.0), (7, 2.0)):
            jp, tp = pockets(seed, stretch)
            want = jm.enable_banding(jp)
            assert tm.enable_banding(tp) == want, (approx, seed)
            assert tm.cfg.egnn.band_window == jm.cfg.egnn.band_window
            assert tm.cfg.egnn.row_tile == jm.cfg.egnn.row_tile
            # every module of the denoiser follows the facade's config,
            # without the band where the window covers the exact bound
            hw = banding.band_halfwidth_atoms(tp.x.numpy(), tp.mask.numpy(),
                                              tm._band_cutoff())
            capped = 0 < want < 2 * hw + tm.cfg.egnn.row_tile
            run = tm.dynamics.egnn.e_block_0.gcl_0.cfg
            assert run == (tm.cfg.egnn if capped else dataclasses.replace(
                tm.cfg.egnn, band_window=None)), (approx, seed)
            assert tm.dynamics.cfg is run
            runs.add((bool(want), capped))
    assert want == 0 or approx != "32" or want == 32
    assert runs == {(True, False), (True, True), (False, False)}


def test_ensure_band_for_follows_jax(models, monkeypatch):
    monkeypatch.delenv("DIFFNDM_BAND_APPROX", raising=False)
    jm, tm = models
    jm.cfg = dataclasses.replace(jm.cfg, egnn=dataclasses.replace(
        jm.cfg.egnn, band_window=None))
    tm.set_egnn_config(dataclasses.replace(tm.cfg.egnn, band_window=None))
    easy, hard = pockets(7, 14.0), pockets(8, 5.0)
    for jp, tp in (easy, hard, easy):
        assert tm.ensure_band_for(tp) == jm.ensure_band_for(jp)
        assert tm.cfg.egnn.band_window == jm.cfg.egnn.band_window


def test_generate_ligands_bands_by_default(monkeypatch, capsys):
    """``generate_ligands`` on a large pocket (the PDB reading replaced by
    the pocket itself): the band by default, with its line; none under
    DIFFNDM_AUTO_BAND=0; the capped window under DIFFNDM_BAND_APPROX."""
    _, tc = tiny_configs()
    model = DiffNDM(tc, device="cpu",
                    sample_cfg=tcfg.SampleConfig(n_samples=2, timesteps=2))
    _, pocket = pockets(5, 12.0)
    monkeypatch.setattr(model, "pocket_from_pdb", lambda *a, **k: pocket)
    sizes = np.array([5, 7])
    monkeypatch.delenv("DIFFNDM_BAND_APPROX", raising=False)
    monkeypatch.setenv("DIFFNDM_AUTO_BAND", "0")
    _, off = model.generate_ligands("p.pdb", "A:1", num_nodes_lig=sizes)
    assert model.cfg.egnn.band_window is None
    assert "[banding]" not in capsys.readouterr().out
    monkeypatch.delenv("DIFFNDM_AUTO_BAND")
    _, dense = model.generate_ligands("p.pdb", "A:1", num_nodes_lig=sizes)
    w = model.cfg.egnn.band_window
    assert w is not None and w < pocket.x.shape[1]
    assert f"[banding] window={w} pocket atoms=128" in capsys.readouterr().out
    # the exact window drops no edge: the denoiser runs without the band
    # and the result is the band-off run's, to the bit
    assert model.dynamics.cfg.band_window is None
    assert torch.equal(dense.ligand.x, off.ligand.x)
    monkeypatch.setenv("DIFFNDM_BAND_APPROX", "32")
    model.set_egnn_config(dataclasses.replace(model.cfg.egnn,
                                              band_window=None))
    model.generate_ligands("p.pdb", "A:1", num_nodes_lig=sizes)
    assert model.cfg.egnn.band_window == 32
    assert model.dynamics.cfg.band_window == 32
    assert np.isfinite(dense.ligand.x.numpy()).all()
