"""The port's FLOP counts, profiling and pictures against the JAX
package's:

- ``egnn_flops_analytic`` equal to JAX's for every configs/*.yml at two
  shapes (ligand rows whole multiples of JAX's 64-row tiles, where its row
  tiles cost nothing extra); the counted plain forward (``forward_flops``,
  hidden 32, 2 layers) above the closed form and within the bracket that
  tests/test_flops.py holds XLA's count to, growing with the edges, and
  smaller in conditional mode than in joint mode; the card's peaks;
- ``trace`` writes a Chrome trace on the CPU that holds the ``annotate``
  spans, honours ``DIFFNDM_TRACE_DIR`` and does nothing without a
  directory (the port's spans are held in tests/test_torch_spans.py);
- the xyz files byte-equal to JAX's and read back the same; PNG and GIF
  renders where matplotlib (and imageio) are installed;
- the chemistry dashboard with ``n_visualize`` = 2: its SDF byte-equal to
  JAX's dashboard's and its renders beside it, and without a renderer the
  JAX dashboard's failure line with the SDF still written.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_jax_native import pin_jax_native  # noqa: E402

pin_jax_native()

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jax_params  # noqa: E402
from diffndm_tpu.structs import NodeBatch as JaxNodeBatch  # noqa: E402
from diffndm_tpu.train.eval_dashboard import \
    ChemistryDashboard as JaxDashboard  # noqa: E402
from diffndm_tpu.utils import flops as jflops  # noqa: E402
from diffndm_tpu.utils import visualization as jviz  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.constants import dataset_params  # noqa: E402
from diffndm_tpu_torch.data.dataset import \
    ProcessedLigandPocketDataset  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.eval_dashboard import \
    ChemistryDashboard  # noqa: E402
from diffndm_tpu_torch.utils import flops, profiling  # noqa: E402
from diffndm_tpu_torch.utils import visualization as viz  # noqa: E402

CONFIGS = sorted(glob.glob("configs/*.yml"))
ANF = 10

# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def test_all_configs_found():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("shape", [(16, 64, 192), (2, 128, 320)])
@pytest.mark.parametrize("path", CONFIGS)
def test_analytic_flops_equal_jax(path, shape):
    ours = tcfg.model_config_from_yaml(tcfg.load_yaml(path))
    ref = jcfg.model_config_from_yaml(jcfg.load_yaml(path))
    assert ref.egnn.row_tile == 64 and ref.egnn.band_window is None
    b, nl, npk = shape
    got = flops.egnn_flops_analytic(ours.egnn, ours.atom_nf, b, nl, npk)
    want = jflops.egnn_flops_analytic(ref.egnn, ref.atom_nf, b, nl, npk)
    assert got == want > 0


def counted(nl, npk, b=1, **kw):
    cfg = tcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2, **kw)
    torch.manual_seed(0)
    return cfg, flops.forward_flops(EGNNDynamics(cfg, ANF, ANF), b, nl, npk)


def test_counted_forward_brackets_the_analytic_count():
    """The closed form counts the dominant matmuls only: below the counted
    forward, by less than 35 % at these widths (tests/test_flops.py's
    bracket for XLA's count)."""
    cfg, x = counted(16, 48, b=2)
    a = flops.egnn_flops_analytic(cfg, ANF, 2, 16, 48)
    assert 0.65 * x["flops"] < a < x["flops"], (a, x)
    assert x["bytes"] > 0


def test_counted_flops_scale_with_edges():
    """Four times the pocket rows: n grows 3x, the edges 9x."""
    _, f1 = counted(16, 32)
    _, f2 = counted(16, 128)
    assert f2["flops"] / f1["flops"] > 5.0, (f1, f2)
    assert f2["bytes"] > f1["bytes"]


def test_counted_conditional_forward_skips_the_frozen_rows():
    cfg_c, f_c = counted(8, 56, update_pocket_coords=False)
    _, f_j = counted(8, 56, update_pocket_coords=True)
    a_c = flops.egnn_flops_analytic(cfg_c, ANF, 1, 8, 56)
    assert f_c["flops"] < 0.72 * f_j["flops"], (f_c, f_j)
    assert 0.6 * f_c["flops"] < a_c < f_c["flops"], (a_c, f_c)


def test_counted_forward_leaves_the_model_alone():
    cfg = tcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2)
    dyn = EGNNDynamics(cfg, ANF, ANF).double()
    before = {k: v.clone() for k, v in dyn.state_dict().items()}
    flops.forward_flops(dyn, 1, 8, 16)
    for k, v in dyn.state_dict().items():
        assert v.dtype == torch.float64 and torch.equal(v, before[k])


def test_peaks_of_the_card():
    kind = "NVIDIA H100 80GB HBM3"
    assert flops.peak_tflops_for(kind) == 989.0
    assert flops.peak_tflops_for(kind, "tf32") == 495.0
    assert flops.peak_tflops_for(kind, "fp32") == 67.0
    assert flops.hbm_gbps_for(kind) == 3350.0
    for other in ("cpu", "NVIDIA H100 PCIe", "TPU v5 lite"):
        assert flops.peak_tflops_for(other) is None
        assert flops.hbm_gbps_for(other) is None


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_the_annotated_spans(tmp_path, monkeypatch):
    monkeypatch.delenv("DIFFNDM_TRACE_DIR", raising=False)
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        for name in ("forward", "backward", "optimizer"):
            with profiling.annotate(name):
                x = torch.tanh(x @ x)
    assert prof is not None
    path = tmp_path / profiling.TRACE_FILE
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("forward", "backward", "optimizer"):
        assert names.count(name) == 1, name
    assert any("mm" in str(n) for n in names)


def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("DIFFNDM_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace() as prof:
        with profiling.annotate("forward"):
            torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []
    monkeypatch.setenv("DIFFNDM_TRACE_DIR", str(tmp_path / "env"))
    with profiling.trace() as prof:
        torch.ones(3).sum()
    assert prof is not None
    assert (tmp_path / "env" / profiling.TRACE_FILE).exists()


# ---------------------------------------------------------------------------
# pictures
# ---------------------------------------------------------------------------

def padded_ligands(indices=(0, 3, 9, 24, 48)):
    """[B, N, ...] arrays of processed test ligands, zero-padded."""
    ds = ProcessedLigandPocketDataset("data/processed/virtual_v3/test.npz")
    items = [ds[i] for i in indices]
    n = max(len(p.lig_coords) for p in items)
    x = np.zeros((len(items), n, 3), np.float32)
    h = np.zeros((len(items), n, ANF), np.float32)
    mask = np.zeros((len(items), n), np.float32)
    for b, p in enumerate(items):
        k = len(p.lig_coords)
        x[b, :k] = p.lig_coords
        h[b, np.arange(k), p.lig_one_hot.argmax(1)] = 1.0
        mask[b, :k] = 1.0
    return x, h, mask


def test_xyz_files_equal_jax(tmp_path):
    x, h, _ = padded_ligands()
    decoder = dataset_params["crossdock_full"]["atom_decoder"]
    enc = dataset_params["crossdock_full"]["atom_encoder"]
    ours = viz.save_xyz_file(str(tmp_path / "port"), h, x, decoder,
                             id_from=3, name="mol")
    ref = jviz.save_xyz_file(str(tmp_path / "jax"), h, x, decoder,
                             id_from=3, name="mol")
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref] == \
        [f"mol_{i:03d}.txt" for i in range(3, 3 + len(x))]
    for a, b in zip(ours, ref):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert viz.load_xyz_files(str(tmp_path / "port")) == ours
    for path in ours:
        pos, oh = viz.load_molecule_xyz(path, enc)
        rpos, roh = jviz.load_molecule_xyz(path, enc)
        np.testing.assert_array_equal(pos, rpos)
        np.testing.assert_array_equal(oh, roh)


def test_renders_to_png_and_gif(tmp_path):
    pytest.importorskip("matplotlib")
    x, h, mask = padded_ligands((0,))
    k = int(mask[0].sum())
    decoder = dataset_params["crossdock_full"]["atom_decoder"]
    types = [decoder[int(t)] for t in h[0, :k].argmax(1)]
    png = viz.plot_molecule_3d(x[0, :k], types, bonds=[(0, 1, 1)],
                               save_path=str(tmp_path / "m.png"))
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    pytest.importorskip("imageio")
    frames = [x[0, :k] * s for s in (1.0, 0.9, 0.8)]
    gif = viz.visualize_chain(frames, [types] * 3, str(tmp_path / "c.gif"))
    with open(gif, "rb") as f:
        assert f.read(6) in (b"GIF89a", b"GIF87a")


def dashboards(tmp_path):
    info = dataset_params["crossdock_full"]
    return (ChemistryDashboard(info, str(tmp_path / "port"), n_visualize=2),
            JaxDashboard(jax_params["crossdock_full"], str(tmp_path / "jax"),
                         n_visualize=2))


def test_dashboard_writes_and_renders_as_jax(tmp_path):
    pytest.importorskip("matplotlib")
    x, h, mask = padded_ligands()
    port, ref = dashboards(tmp_path)
    got = port.analyze(NodeBatch(*(torch.from_numpy(a)
                                   for a in (x, h, mask))), epoch=2,
                       dump_sdf=True)
    want = ref.analyze(JaxNodeBatch(x, h, mask), epoch=2, dump_sdf=True)
    assert got == want
    with open(tmp_path / "port" / "eval_ep2.sdf", "rb") as a, \
            open(tmp_path / "jax" / "eval_ep2.sdf", "rb") as b:
        sdf = a.read()
        assert sdf == b.read() and sdf.count(b"$$$$") > 0
    pngs = sorted(os.listdir(tmp_path / "port" / "viz_ep2"))
    assert pngs == sorted(os.listdir(tmp_path / "jax" / "viz_ep2"))
    assert len(pngs) == sdf.count(b"$$$$")


def test_dashboard_without_a_renderer_says_why(tmp_path, monkeypatch,
                                               capsys):
    """The renderer failing (here: matplotlib missing) prints the JAX
    dashboard's line, in both; the SDF is written all the same."""
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)

    x, h, mask = padded_ligands()
    port, ref = dashboards(tmp_path)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    port.analyze(NodeBatch(*(torch.from_numpy(a) for a in (x, h, mask))),
                 dump_sdf=True)
    ref.analyze(JaxNodeBatch(x, h, mask), dump_sdf=True)
    monkeypatch.undo()
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["[dashboard] visualization failed: No module named "
                     "'matplotlib'"] * 2
    for side in ("port", "jax"):
        assert (tmp_path / side / "eval_ep0.sdf").exists()
        assert os.listdir(tmp_path / side / "viz_ep0") == []
