"""The JAX package's last surface in the port: the guidance fan-out's own
row tile, the trajectory frame tap, the guided-phase profile, the EDM
bond table and XYZ files, each against its JAX function.

- ``SampleConfig.fanout_row_tile`` (``diffusion/sampler.fanout_eps``), on
  a small random one-layer EGNN (its coordinate update reads the pocket's
  updated features, which the band restricts) and JAX's elongated
  64-atom pocket, the port fed the noise JAX's key schedule drew, guided
  (SPSA, ATP, the hybrid) and inpainting (SPSA, ATP).  Under an exact
  window (48 at tile 8; the fan-out's 56 at tile 16) the port with the
  field equals its own run without it to the bit, and JAX's
  host-orchestrated loop with the field (``HostGuidedSampler``,
  ``DIFFNDM_HOST_GUIDANCE=1``).  Under a capped window (8 at tile 8,
  below the pocket's exact bound) the port with the field equals JAX's
  host loop with it (``HostGuidedSampler``, ``HostGuidedInpainter``),
  and scores other populations than its own run without it.  Tolerance:
  the guided replay's (``tests/test_torch_sampler.py``): coordinates
  within 1e-3 A, masks and atom types identical; so for every population
  the oracle scores, in order.
- The frame tap (``set_frame_tap``, ``make_sdf_frame_tap``): the port's
  files against JAX's tap on the same noise: the same file names, atoms
  and bonds equal, coordinates within 1e-4 A plus the two files' 4-decimal
  rounding; under a data group (two gloo ranks) rank 0 alone writes the
  files of one process.
- ``DIFFNDM_GUIDED_PROFILE=1``: results bit-equal to the run without it;
  the report names every phase JAX's host loop times for the same
  events, each timed as many times.
- ``chem.bonds.bond_order_matrix`` and ``build_molecule(use_edm=True)``
  equal JAX's on seeded clouds and on pairs on each margin's edge, in
  every dataset encoding; ``write_xyz`` byte-equal, ``read_xyz`` equal to
  JAX's and the inverse of ``write_xyz``.

Torch runs on one thread around its ops (the ROADMAP's ground rules).
"""

import contextlib
import dataclasses
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.chem import bonds as jbonds  # noqa: E402
from diffndm_tpu.chem import io as jio  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.diffusion import inpaint as jinpaint  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.diffusion.core import CondDiffusion as JaxCore  # noqa: E402
from diffndm_tpu.diffusion.sampler import \
    ConditionalSampler as JaxSampler  # noqa: E402
from diffndm_tpu.diffusion.sampler import \
    make_sdf_frame_tap as jax_frame_tap  # noqa: E402
from diffndm_tpu.models.banding import band_halfwidth_atoms  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxBatch  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.chem import bonds  # noqa: E402
from diffndm_tpu_torch.chem import io as tio  # noqa: E402
from diffndm_tpu_torch.constants import (MARGIN1, MARGIN2,  # noqa: E402
                                         MARGIN3, dataset_params)
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.diffusion.core import CondDiffusion  # noqa: E402
from diffndm_tpu_torch.diffusion.inpaint import (InpaintSampler,  # noqa: E402
                                                 inpaint_events)
from diffndm_tpu_torch.diffusion.sampler import (  # noqa: E402
    ConditionalSampler, guidance_events, make_sdf_frame_tap)
from diffndm_tpu_torch.guidance.oracle import RewardOracle  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from test_torch_dynamics import port_dynamics  # noqa: E402
from test_torch_inpaint import jax_inpaint_noise  # noqa: E402
from test_torch_sampler import jax_guided_noise, jax_noise  # noqa: E402

NF = 10
DP = dataset_params["crossdock_full"]
COORD_ATOL = 1e-3           # Angstrom, the guided replay's
TAP_ATOL = 1e-4 + 1e-4      # Angstrom, plus the files' 4-decimal rounding
T, SEED = 8, 5
NL, NPK = 8, 64
SIZES = np.array([5, 7])
GUIDED = dict(spsa=dict(enabled=True, num_probes=2, start_step=4, every=2,
                        zeta0=5.0),
              atp=dict(enabled=True, num_groups=3, start_step=6, every=2))
# (row_tile, band_window) of the denoiser; the fan-out's tile is 16
BANDS = {"exact": (8, 48), "capped": (8, 8)}
# the small EGNN's messages summed over 10 rather than 100, its coordinate
# output layers scaled up 300 times, and a schedule of precision 0.25: the
# pocket's rows reach the ligand's eps and the ligand stays within the
# pocket's cutoff, so that the capped band moves what the fan-out scores
NORM_FACTOR, COORD_GAIN, PRECISION = 10.0, 300.0, 0.25
T_INP, R_INP = 6, 2
INPAINT = dict(spsa=dict(enabled=True, num_probes=2, zeta0=5.0),
               atp=dict(num_groups=3),
               inpaint=dict(spsa_low=3, spsa_high=4, spsa_zeta_denom=300.0,
                            atp_start_step=4, atp_every=2))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def elongated_pocket(b):
    """JAX's tests/test_host_guided.py pocket: 64 atoms along a line with
    jitter, so that the sorted band's half-width is small."""
    key = jax.random.PRNGKey(3)
    zline = jnp.linspace(0.0, 2.0 * NPK, NPK)[None, :, None]
    jitter = jax.random.normal(key, (1, NPK, 3)) * 0.5
    x = jnp.concatenate([jitter[..., :2], zline + jitter[..., 2:]], -1) + 4.0
    h = jax.nn.one_hot(jax.random.randint(key, (1, NPK), 0, 4), NF)
    return (np.broadcast_to(np.asarray(x), (b, NPK, 3)).copy(),
            np.broadcast_to(np.asarray(h), (b, NPK, NF)).copy(),
            np.ones((b, NPK), np.float32))


class Pair:
    """One small random EGNN on both sides at a band; the port's
    denoiser, core and oracle, JAX's module, params and core."""

    def __init__(self, row_tile, window):
        self.jax_cfg = jcfg.EGNNConfig(
            hidden_nf=16, joint_nf=8, n_layers=1, row_tile=row_tile,
            attention=False, reflection_equivariant=True,
            normalization_factor=NORM_FACTOR,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0,
            band_window=window)
        self.module = JaxDynamics(self.jax_cfg, atom_nf=NF, residue_nf=NF)
        params = jax.jit(self.module.init)(
            jax.random.PRNGKey(3), jnp.zeros((1, NL, 3 + NF)),
            jnp.zeros((1, NPK, 3 + NF)), jnp.zeros((1,)), jnp.ones((1, NL)),
            jnp.ones((1, NPK)))
        self.params = jax.tree_util.tree_map_with_path(
            lambda path, v: v * COORD_GAIN if "coord_out" in
            jax.tree_util.keystr(path) else v, params)
        d = jcfg.DiffusionConfig(timesteps=T)
        self.jax_core = JaxCore(jS.make_schedule("polynomial_2", T,
                                                 PRECISION), d, NF, NF)
        egnn = tcfg.EGNNConfig(**{f.name: getattr(self.jax_cfg, f.name)
                                  for f in dataclasses.fields(
                                      tcfg.EGNNConfig)})
        self.dynamics = port_dynamics(egnn, NF, NF, self.params)
        td = tcfg.DiffusionConfig(timesteps=T)
        self.core = CondDiffusion(tS.make_schedule("polynomial_2", T,
                                                   PRECISION), td, NF, NF)
        self.oracle = RewardOracle(DP, scorer="native")


_PAIRS = {}


def pair_at(band):
    if band not in _PAIRS:
        _PAIRS[band] = Pair(*BANDS[band])
    return _PAIRS[band]


def host_guidance(fn, *args, **kw):
    """fn under JAX's host-orchestrated loops (set and popped here)."""
    os.environ["DIFFNDM_HOST_GUIDANCE"] = "1"
    try:
        return fn(*args, **kw)
    finally:
        os.environ.pop("DIFFNDM_HOST_GUIDANCE", None)


def guided_cfgs(fanout):
    port = tcfg.SampleConfig(spsa=tcfg.SPSAConfig(**GUIDED["spsa"]),
                             atp=tcfg.ATPConfig(**GUIDED["atp"]),
                             fanout_row_tile=fanout)
    jax_cfg = jcfg.SampleConfig(spsa=jcfg.SPSAConfig(**GUIDED["spsa"]),
                                atp=jcfg.ATPConfig(**GUIDED["atp"]),
                                fanout_row_tile=fanout)
    return port, jax_cfg


def inpaint_cfgs(fanout):
    port = tcfg.SampleConfig(
        spsa=tcfg.SPSAConfig(**INPAINT["spsa"]),
        atp=tcfg.ATPConfig(**INPAINT["atp"]),
        inpaint=tcfg.InpaintConfig(**INPAINT["inpaint"]),
        fanout_row_tile=fanout)
    jax_cfg = jcfg.SampleConfig(
        spsa=jcfg.SPSAConfig(**INPAINT["spsa"]),
        atp=jcfg.ATPConfig(**INPAINT["atp"]),
        inpaint=jcfg.InpaintConfig(**INPAINT["inpaint"]),
        fanout_row_tile=fanout)
    return port, jax_cfg


def guided_inputs():
    x, h, m = elongated_pocket(len(SIZES))
    return (JaxBatch(jnp.asarray(x), jnp.asarray(h), jnp.asarray(m)),
            NodeBatch(*(torch.from_numpy(a) for a in (x, h, m))))


def inpaint_inputs():
    """Two ligands of 6 and 7 atoms near the pocket's middle, the first 3
    fixed, in the elongated pocket: (ligand, lig_fixed, pocket) for JAX
    and for the port."""
    rng = np.random.default_rng(11)
    b = len(SIZES)
    x = np.zeros((b, NL, 3), np.float32)
    h = np.zeros((b, NL, NF), np.float32)
    mask = np.zeros((b, NL), np.float32)
    fixed = np.zeros((b, NL), np.float32)
    for i, n in enumerate((6, 7)):
        x[i, :3] = rng.normal(size=(3, 3)) * 1.2 + (4.0, 4.0, 68.0)
        h[i, np.arange(3), rng.integers(0, 4, 3)] = 1.0
        mask[i, :n] = 1.0
        fixed[i, :3] = 1.0
    px, ph, pm = elongated_pocket(b)
    j = [jnp.asarray(a) for a in (x, h, mask, fixed, px, ph, pm)]
    t = [torch.from_numpy(a) for a in (x, h, mask, fixed, px, ph, pm)]
    return ((JaxBatch(*j[:3]), j[3], JaxBatch(*j[4:])),
            (NodeBatch(*t[:3]), t[3], NodeBatch(*t[4:])))


class Scored:
    """The populations an oracle scores (coordinates in A, atom types),
    in call order, while the block runs."""

    def __init__(self, oracle):
        self.oracle, self.seen = oracle, []

    def __enter__(self):
        score = self.oracle.score_batch_types

        def recording(coords, types, mask, weights):
            self.seen.append((np.array(coords, np.float32),
                              np.array(types, np.int64)))
            return score(coords, types, mask, weights)

        self.oracle.score_batch_types = recording
        return self.seen

    def __exit__(self, *exc):
        del self.oracle.score_batch_types


_JAX_RUNS = {}


def jax_run(kind, band):
    """JAX's host-orchestrated loop with fanout_row_tile=16 and its
    profile on (which blocks on values and changes no result), once per
    kind and band: (result, scored populations, printed report, phase
    counts)."""
    if (kind, band) not in _JAX_RUNS:
        pair = pair_at(band)
        text = io.StringIO()
        os.environ["DIFFNDM_GUIDED_PROFILE"] = "1"
        try:
            if kind == "guided":
                sampler = JaxSampler(pair.jax_core, pair.module, pair.params,
                                     guided_cfgs(16)[1], DP)
                with Scored(sampler.oracle) as seen, \
                        contextlib.redirect_stdout(text):
                    ref = host_guidance(
                        sampler.sample_given_pocket,
                        jax.random.PRNGKey(SEED), guided_inputs()[0], SIZES,
                        timesteps=T)
                counts = dict(sampler._run_cache["host"].prof.count)
            else:
                sampler = jinpaint.InpaintSampler(
                    pair.jax_core, pair.module, pair.params,
                    inpaint_cfgs(16)[1], DP)
                ligand, fixed, pocket = inpaint_inputs()[0]
                with Scored(sampler.oracle) as seen:
                    ref = host_guidance(
                        sampler.inpaint, jax.random.PRNGKey(SEED), ligand,
                        fixed, pocket, timesteps=T_INP, resamplings=R_INP,
                        svdd=True, spsa=True)
                counts = dict(sampler._cache["host"].prof.count)
        finally:
            os.environ.pop("DIFFNDM_GUIDED_PROFILE", None)
        _JAX_RUNS[kind, band] = (ref, seen, text.getvalue(), counts)
    return _JAX_RUNS[kind, band]


def port_run(kind, band, fanout):
    """The port's loop on the same inputs, fed JAX's noise: (result,
    scored populations)."""
    pair = pair_at(band)
    with Scored(pair.oracle) as seen:
        if kind == "guided":
            cfg = guided_cfgs(fanout)[0]
            sampler = ConditionalSampler(pair.core, pair.dynamics, cfg,
                                         pair.oracle)
            noise = jax_guided_noise(jax.random.PRNGKey(SEED), cfg,
                                     (len(SIZES), NL, 3 + NF), T)
            out = sampler.sample_given_pocket(guided_inputs()[1], SIZES,
                                              timesteps=T, noise=noise)
        else:
            cfg = inpaint_cfgs(fanout)[0]
            noise = jax_inpaint_noise(jax.random.PRNGKey(SEED), cfg,
                                      (len(SIZES), NL, 3 + NF), T_INP,
                                      R_INP, True, True)
            out = InpaintSampler(pair.core, pair.dynamics, cfg,
                                 pair.oracle).inpaint(
                *inpaint_inputs()[1], timesteps=T_INP, resamplings=R_INP,
                svdd=True, spsa=True, noise=noise)
    return out, seen


def assert_same(out, ref):
    """The guided replay's check: masks, surviving rows' types and the
    pocket identical, coordinates within COORD_ATOL."""
    mask = np.asarray(ref.ligand.mask)
    np.testing.assert_array_equal(out.ligand.mask.numpy(), mask)
    x_out = out.ligand.x.numpy()
    assert np.all(np.isfinite(x_out))
    np.testing.assert_allclose(x_out, np.asarray(ref.ligand.x), rtol=0,
                               atol=COORD_ATOL)
    m = mask > 0.5
    np.testing.assert_array_equal(out.ligand.h.numpy().argmax(-1)[m],
                                  np.asarray(ref.ligand.h).argmax(-1)[m])
    np.testing.assert_allclose(out.pocket.x.numpy(),
                               np.asarray(ref.pocket.x), rtol=0,
                               atol=COORD_ATOL)


def assert_same_populations(mine, theirs):
    """Every population scored, in order: coordinates within COORD_ATOL,
    atom types identical."""
    assert len(mine) == len(theirs)
    for (x, t), (xr, tr) in zip(mine, theirs):
        np.testing.assert_allclose(x, xr, rtol=0, atol=COORD_ATOL)
        np.testing.assert_array_equal(t, tr)


def assert_bits(a, b):
    for u, v in zip((a.ligand.x, a.ligand.h, a.ligand.mask, a.pocket.x),
                    (b.ligand.x, b.ligand.h, b.ligand.mask, b.pocket.x)):
        assert torch.equal(u, v)


def halfwidth():
    x, _, m = elongated_pocket(1)
    return band_halfwidth_atoms(x, m, 5.0)


def test_the_bands_are_what_they_claim():
    """48 at tile 8 and the fan-out's 56 at tile 16 are exact for the
    pocket (JAX's test's assertion); 8 at tile 8 is not.  Events: ATP at
    s = 6, 4, 2, 0, SPSA at 4, 2, 0, the hybrid at 4 (guided); SPSA at
    s = 4, 3, ATP at 4, 2, 0 of 6 steps x 2 resamplings (inpainting)."""
    hw = halfwidth()
    assert 48 >= 2 * hw + 8 and 56 >= 2 * hw + 16, hw
    assert 8 < 2 * hw + 8, hw
    assert guidance_events(guided_cfgs(16)[0], T) == dict(
        atp=[6, 4, 2, 0], spsa=[4, 2, 0], hybrid=[4])
    assert inpaint_events(inpaint_cfgs(16)[0], T_INP, True, True) == dict(
        spsa=[4, 3], atp=[4, 2, 0])


@pytest.mark.parametrize("fanout", [8, 16])
def test_fanout_row_tile_keeps_an_exact_band(fanout):
    """Under an exact window every tile keeps every edge: the port's
    guided run with the field (8, the denoiser's own tile; 16, the window
    widened to 56) is its run without it, to the bit."""
    out, _ = port_run("guided", "exact", fanout)
    base, _ = port_run("guided", "exact", None)
    assert_bits(out, base)


def test_fanout_row_tile_equals_jaxs_host_loop_under_an_exact_band():
    out, seen = port_run("guided", "exact", 16)
    ref, theirs, _, _ = jax_run("guided", "exact")
    assert pair_at("exact").oracle.n_python_rows == 0
    assert_same(out, ref)
    assert_same_populations(seen, theirs)


@pytest.mark.parametrize("kind", ["guided", "inpaint"])
def test_fanout_row_tile_under_a_capped_band(kind):
    """A capped window drops real edges, and which ones depends on the
    tile.  The fan-out at tile 16 (window 16) computes what JAX's host
    loop computes with the field: the result, and every population it
    scores.  The fan-out at the denoiser's tile 8 (window 8) scores other
    populations."""
    out, seen = port_run(kind, "capped", 16)
    ref, theirs, _, _ = jax_run(kind, "capped")
    assert_same(out, ref)
    assert_same_populations(seen, theirs)
    _, base = port_run(kind, "capped", None)
    moved = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(seen, base))
    assert moved > 10 * COORD_ATOL, moved


def test_inpainting_fanout_row_tile_keeps_an_exact_band():
    out, _ = port_run("inpaint", "exact", 16)
    base, _ = port_run("inpaint", "exact", None)
    assert_bits(out, base)


# ---------------------------------------------------------------------------
# the guided-phase profile
# ---------------------------------------------------------------------------

def report_counts(text):
    """{phase: calls} of a printed profile report."""
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^  (\S+)\s+[0-9.]+  x(\d+)$", text, re.M)}


@pytest.mark.parametrize("kind", ["guided", "inpaint"])
def test_profile_changes_no_result_and_names_jaxs_phases(kind, capsys,
                                                         monkeypatch):
    """The port's report, printed once, times every phase JAX's host loop
    times for the same events, as many times; the result is the run's
    without the profile, to the bit."""
    base, _ = port_run(kind, "capped", 16)
    capsys.readouterr()
    monkeypatch.setenv("DIFFNDM_GUIDED_PROFILE", "1")
    out, _ = port_run(kind, "capped", 16)
    mine = capsys.readouterr().out
    assert_bits(out, base)
    assert mine.count("guided-phase profile (s, calls):") == 1
    _, _, text, counts = jax_run(kind, "capped")
    if kind == "guided":
        assert report_counts(text) == counts
        assert {"segment", "decode", "hyb.look"} <= set(counts)
    assert {f"{e}.{p}" for e, ps in (
        ("spsa", ("probe", "fetch", "score", "apply")),
        ("atp", ("cand", "fetch", "score", "select"))) for p in ps} <= \
        set(counts)
    assert report_counts(mine) == counts


# ---------------------------------------------------------------------------
# the frame tap
# ---------------------------------------------------------------------------

def test_frame_tap_writes_jaxs_files(tmp_path):
    """JAX's tests/test_virtual_and_tap.py run (T=6, every=2, unguided):
    the port's tap writes the files JAX's writes, with the same
    molecules."""
    steps, b, npk = 6, 2, 12
    cfg = jcfg.EGNNConfig(hidden_nf=16, joint_nf=8, n_layers=1,
                          row_tile=16, attention=False,
                          reflection_equivariant=True)
    module = JaxDynamics(cfg, atom_nf=NF, residue_nf=NF)
    key = jax.random.PRNGKey(0)
    params = module.init(key, jnp.zeros((1, NL, 13)),
                         jnp.zeros((1, npk, 13)), jnp.zeros((1,)),
                         jnp.ones((1, NL)), jnp.ones((1, npk)))
    d = jcfg.DiffusionConfig(timesteps=steps)
    jcore = JaxCore(jS.make_schedule("polynomial_2", steps, 5e-4), d, NF,
                    NF)
    pocket = JaxBatch(
        x=jax.random.normal(key, (b, npk, 3)) * 2 + 5,
        h=jax.nn.one_hot(jax.random.randint(key, (b, npk), 0, 4), NF),
        mask=jnp.ones((b, npk)))
    sampler = JaxSampler(jcore, module, params, jcfg.SampleConfig(), DP)
    sampler.set_frame_tap(jax_frame_tap(str(tmp_path / "jax"), DP, jcore,
                                        every=2))
    sizes = np.array([5, 6])
    sampler.sample_given_pocket(jax.random.PRNGKey(1), pocket, sizes)

    egnn = tcfg.EGNNConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(tcfg.EGNNConfig)})
    core = CondDiffusion(tS.make_schedule("polynomial_2", steps, 5e-4),
                         tcfg.DiffusionConfig(timesteps=steps), NF, NF)
    port = ConditionalSampler(core, port_dynamics(egnn, NF, NF, params),
                              tcfg.SampleConfig())
    seen = []
    tap = make_sdf_frame_tap(str(tmp_path / "port"), DP, core, every=2)
    port.set_frame_tap(lambda s, *a: (seen.append(s), tap(s, *a)))
    port.sample_given_pocket(
        NodeBatch(*(torch.from_numpy(np.array(a)) for a in pocket)), sizes,
        timesteps=steps,
        noise=jax_noise(jax.random.PRNGKey(1), (b, NL, 3 + NF), steps))
    assert seen == list(range(steps - 1, -1, -1))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["try_0.sdf", "try_2.sdf", "try_4.sdf"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        mine = tio.read_sdf(str(tmp_path / "port" / name))
        theirs = tio.read_sdf(str(tmp_path / "jax" / name))
        assert len(mine) == len(theirs) == b
        for m, t in zip(mine, theirs):
            assert m.symbols == t.symbols and m.bonds == t.bonds
            np.testing.assert_allclose(m.coords, t.coords, rtol=0,
                                       atol=TAP_ATOL)


# ---------------------------------------------------------------------------
# the EDM bond table, XYZ files
# ---------------------------------------------------------------------------

def edge_pairs(info, rng):
    """Two-atom clouds at each tabulated length plus its margin, a hair
    (1e-4 pm) below and above, and exactly there."""
    out = []
    n_types = len(info["atom_decoder"])
    for k, margin in ((1, MARGIN1), (2, MARGIN2), (3, MARGIN3)):
        table = np.asarray(info[f"bonds{k}"])
        i, j = np.nonzero(table[:n_types, :n_types] > 0)
        pick = rng.choice(len(i), size=min(6, len(i)), replace=False)
        for a, b in zip(i[pick], j[pick]):
            for delta in (-1e-4, 0.0, 1e-4):
                d = (table[a, b] + margin + delta) / 100.0
                direction = rng.normal(size=3)
                direction /= np.linalg.norm(direction)
                x0 = rng.normal(size=3)
                out.append((np.stack([x0, x0 + d * direction]).astype(
                    np.float32), np.array([a, b])))
    return out


@pytest.mark.parametrize("dataset", sorted(dataset_params))
def test_edm_bond_rule_equals_jax(dataset):
    info, jinfo = dataset_params[dataset], jax_params[dataset]
    rng = np.random.default_rng(5)
    n_types = len(info["atom_decoder"])
    clouds = [(rng.normal(size=(n, 3)).astype(np.float32) * scale,
               rng.integers(0, n_types, n))
              for n, scale in ((1, 1.0), (7, 1.0), (12, 1.3), (20, 1.6))]
    clouds.append((np.zeros((0, 3), np.float32), np.zeros(0, np.int64)))
    clouds += edge_pairs(info, rng)
    orders = set()
    for coords, types in clouds:
        mine = bonds.bond_order_matrix(coords, types, info)
        theirs = jbonds.bond_order_matrix(coords, types, jinfo)
        assert mine.dtype == theirs.dtype == np.int8
        np.testing.assert_array_equal(mine, theirs)
        orders.update(np.unique(mine).tolist())
        m = bonds.build_molecule(coords, types, info, use_edm=True)
        j = jbonds.build_molecule(coords, types, jinfo, use_edm=True)
        assert m.symbols == j.symbols and m.bonds == j.bonds
        np.testing.assert_array_equal(m.coords, j.coords)
        assert m.coords.dtype == np.float64
    assert {0, 1, 2, 3} <= orders


def test_build_molecule_default_is_perception():
    rng = np.random.default_rng(2)
    coords = rng.normal(size=(9, 3)).astype(np.float32) * 1.2
    types = rng.integers(0, 4, 9)
    assert bonds.build_molecule(coords, types, DP).bonds == \
        bonds.build_molecule(coords, types, DP, use_edm=False).bonds
    assert bonds.build_molecules_batch(coords[None], types[None],
                                       np.ones((1, 9)), DP)[0].bonds == \
        jbonds.build_molecules_batch(coords[None], types[None],
                                     np.ones((1, 9)),
                                     jax_params["crossdock_full"])[0].bonds


@pytest.mark.parametrize("n", [0, 1, 9])
def test_xyz_files_equal_jaxs(tmp_path, n):
    rng = np.random.default_rng(n)
    coords = rng.normal(size=(n, 3)) * 3.0
    symbols = [DP["atom_decoder"][i] for i in rng.integers(0, 10, n)]
    tio.write_xyz(str(tmp_path / "port.xyz"), coords, symbols)
    jio.write_xyz(str(tmp_path / "jax.xyz"), coords, symbols)
    assert (tmp_path / "port.xyz").read_bytes() == \
        (tmp_path / "jax.xyz").read_bytes()
    back, names = tio.read_xyz(str(tmp_path / "port.xyz"))
    j_back, j_names = jio.read_xyz(str(tmp_path / "port.xyz"))
    assert names == j_names == symbols
    np.testing.assert_array_equal(back, j_back)
    if n:
        np.testing.assert_allclose(back, coords, rtol=0, atol=5e-10)


def test_frame_tap_under_a_data_group(tmp_path):
    """Two gloo ranks sampling one batch: rank 0 writes each frame from
    the all-gathered rows, the files of one process on the same noise
    (molecules equal, coordinates within TAP_ATOL); the other rank writes
    nothing."""
    import torch_tap_ranks
    from diffndm_tpu_torch.models.dynamics import EGNNDynamics
    from diffndm_tpu_torch.parallel import mesh

    torch.manual_seed(0)
    egnn = dict(hidden_nf=16, joint_nf=8, n_layers=1, attention=False,
                reflection_equivariant=True)
    state = {k: v.numpy() for k, v in EGNNDynamics(
        tcfg.EGNNConfig(**egnn), NF, NF).state_dict().items()}
    rng = np.random.default_rng(4)
    b, npk, steps = 4, 12, 4
    shape = (b, NL, 3 + NF)
    spec = dict(
        T=steps, egnn=egnn, state=state, every=2, sizes=np.array([5, 6, 7,
                                                                   4]),
        pocket=((rng.standard_normal((b, npk, 3)) * 2 + 5).astype(
            np.float32), np.eye(NF, dtype=np.float32)[
                rng.integers(0, 4, (b, npk))], np.ones((b, npk), np.float32)),
        noise={k: rng.standard_normal(lead + shape).astype(np.float32)
               for k, lead in (("init", ()), ("steps", (steps,)),
                               ("decode", ()))})
    one = torch_tap_ranks.tap_rank(None, dict(spec, out=str(tmp_path / "one")))
    ranks = mesh.spawn(torch_tap_ranks.tap_rank, 2, "gloo",
                       args=(dict(spec, out=str(tmp_path / "dp")),),
                       timeout=120.0)
    names = ["try_0.sdf", "try_2.sdf"]
    assert one == (names, ["try_2.sdf", "try_0.sdf"])
    assert ranks == [one, (names, [])]
    for name in names:
        mine = tio.read_sdf(str(tmp_path / "dp" / name))
        theirs = tio.read_sdf(str(tmp_path / "one" / name))
        assert len(mine) == len(theirs) == b
        for m, t in zip(mine, theirs):
            assert m.symbols == t.symbols and m.bonds == t.bonds
            np.testing.assert_allclose(m.coords, t.coords, rtol=0,
                                       atol=TAP_ATOL)
