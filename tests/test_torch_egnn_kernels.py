"""The port's plain EGNN edge-chain functions against the JAX Pallas
kernels they replace (interpret mode on the CPU, fp32 matrix unit).

Both sides compute in fp32 and differ only in the order of their sums,
so the tolerance is rtol 1e-5, atol 1e-6.  On the CPU the port's
wrappers take the plain path; that they do so only for CPU tensors is
checked too.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

The kernels multiply by W2 on the TF32 tensor cores as a three-term split.
What can be shown of that without the card is shown here: the split's
arithmetic, emulated in fp32 with TF32-rounded operands, on the v3b
weights; the layout in which the wrapper hands W2 over and its cache; and
that the pair entry equals its two single calls.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from diffndm_tpu.ops import pallas_egnn as PK  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
H = 32
NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
RUN = "examples/checkpoints/virtual_cond_v3b"
# the gate chip_smoke.py holds a kernel to against its plain version
GATE_RTOL, GATE_ATOL = 1e-4, 1e-5


def make_inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    x0 = (rng.normal(size=(b, n, 3)) * 2).astype(np.float32)
    d2c = ((x[:, :, None] - x[:, None, :]) ** 2).sum(-1)
    d2i = ((x0[:, :, None] - x0[:, None, :]) ** 2).sum(-1)
    adj = (rng.uniform(size=(b, n, n)) > 0.3).astype(np.float32)
    f = np.float32
    return dict(
        a=rng.normal(size=(b, n, H)).astype(f),
        b=rng.normal(size=(b, n, H)).astype(f),
        d2c=d2c.astype(f), d2i=d2i.astype(f), adj=adj,
        we=(rng.normal(size=(2, H)) * 0.2).astype(f),
        w2=(rng.normal(size=(H, H)) * 0.1).astype(f),
        b2=(rng.normal(size=(H,)) * 0.1).astype(f),
        watt=(rng.normal(size=(H, 1)) * 0.1).astype(f),
        batt=(rng.normal(size=(1,)) * 0.1).astype(f),
        wout=(rng.normal(size=(H, 1)) * 0.1).astype(f),
        x=x, center=x.mean(axis=1, keepdims=True))


def as_torch(d, keys):
    return [torch.from_numpy(d[k]) for k in keys]


GCL_KEYS = ("a", "b", "d2c", "d2i", "adj", "we", "w2", "b2", "watt", "batt")
VEC_KEYS = ("a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
            "wout")


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("n,row_tile,col_tile", [(40, 16, 128),
                                                 (37, 16, 16)])
def test_gcl_messages_plain_matches_pallas(attention, n, row_tile,
                                           col_tile):
    d = make_inputs(2, n, seed=n)
    ref = PK.gcl_messages(*[jnp.asarray(d[k]) for k in GCL_KEYS],
                          attention=attention, norm_factor=100.0,
                          row_tile=row_tile, col_tile=col_tile,
                          interpret=True, mxu_dtype=jnp.float32)
    out = K.gcl_messages(*as_torch(d, GCL_KEYS), attention=attention,
                         norm_factor=100.0)
    assert out.shape == (2, n, H) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n,row_tile,col_tile", [(40, 16, 128),
                                                 (37, 16, 16)])
def test_edge_vector_reduce_plain_matches_pallas(cross, tanh, n, row_tile,
                                                 col_tile):
    d = make_inputs(2, n, seed=100 + n)
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0, cross=cross,
              norm_factor=100.0)
    ref = PK.edge_vector_reduce(*[jnp.asarray(d[k]) for k in VEC_KEYS],
                                row_tile=row_tile, col_tile=col_tile,
                                interpret=True, mxu_dtype=jnp.float32, **kw)
    out = K.edge_vector_reduce(*as_torch(d, VEC_KEYS), **kw)
    assert out.shape == (2, n, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
def test_edge_vector_reduce_n_rows(cross):
    """Rows below n_rows match the full Pallas result; the rest are 0."""
    n, n_rows = 37, 13
    d = make_inputs(2, n, seed=7)
    kw = dict(tanh=True, coords_range=15.0, norm_constant=1.0, cross=cross,
              norm_factor=100.0)
    ref = np.asarray(PK.edge_vector_reduce(
        *[jnp.asarray(d[k]) for k in VEC_KEYS], row_tile=16, col_tile=16,
        interpret=True, mxu_dtype=jnp.float32, **kw))
    out = K.edge_vector_reduce(*as_torch(d, VEC_KEYS), n_rows=n_rows,
                               **kw).numpy()
    np.testing.assert_allclose(out[:, :n_rows], ref[:, :n_rows], rtol=RTOL,
                               atol=ATOL)
    assert np.all(out[:, n_rows:] == 0.0)


def test_plain_row_chunking_agrees(monkeypatch):
    """Splitting the [B, T, N, H] chain into row chunks changes only the
    blocking of the matrix product (same tolerance as above)."""
    d = make_inputs(2, 37, seed=11)
    full = K.gcl_messages(*as_torch(d, GCL_KEYS)).numpy()
    vec = K.edge_vector_reduce(*as_torch(d, VEC_KEYS), cross=True).numpy()
    monkeypatch.setattr(K, "_PLAIN_CHUNK_ELEMS", 2 * 37 * H * 5)
    np.testing.assert_allclose(
        K.gcl_messages(*as_torch(d, GCL_KEYS)).numpy(), full, rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        K.edge_vector_reduce(*as_torch(d, VEC_KEYS), cross=True).numpy(),
        vec, rtol=RTOL, atol=ATOL)


def pair_args(d, e):
    """Arguments of edge_vector_reduce_pair from two input sets that share
    the graph of the first."""
    two = {k: (torch.from_numpy(d[k]), torch.from_numpy(e[k]))
           for k in ("a", "b", "we", "w2", "b2", "wout")}
    shared = as_torch(d, ("d2c", "d2i", "adj", "x", "center"))
    return [two["a"], two["b"], *shared, two["we"], two["w2"], two["b2"],
            two["wout"]]


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    d = make_inputs(1, 9, seed=3)
    K.reset_launches()
    K.gcl_messages(*as_torch(d, GCL_KEYS))
    K.edge_vector_reduce(*as_torch(d, VEC_KEYS))
    K.edge_vector_reduce_pair(*pair_args(d, make_inputs(1, 9, seed=5)))
    assert K.LAUNCHES == {"gcl_messages": 0, "edge_vector_reduce": 0}


@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 13, 0])
def test_pair_is_the_sum_of_its_two_single_calls(tanh, n_rows):
    """Exactly: the first set along the difference direction, the second
    along the cross direction."""
    d, e = make_inputs(2, 37, seed=21), make_inputs(2, 37, seed=22)
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0,
              norm_factor=100.0, n_rows=n_rows)
    pair = K.edge_vector_reduce_pair(*pair_args(d, e), **kw)
    shared = {k: d[k] for k in ("d2c", "d2i", "adj", "x", "center")}
    parts = [K.edge_vector_reduce(*as_torch({**s, **shared}, VEC_KEYS),
                                  cross=cross, **kw)
             for s, cross in ((d, False), (e, True))]
    assert torch.equal(pair, parts[0] + parts[1])
    rows = 37 if n_rows is None else n_rows
    assert torch.all(pair[:, rows:] == 0.0)


def test_pair_matches_pallas_twice():
    d, e = make_inputs(2, 37, seed=23), make_inputs(2, 37, seed=24)
    kw = dict(tanh=True, coords_range=15.0, norm_constant=1.0,
              norm_factor=100.0)
    shared = {k: d[k] for k in ("d2c", "d2i", "adj", "x", "center")}
    ref = sum(np.asarray(PK.edge_vector_reduce(
        *[jnp.asarray({**s, **shared}[k]) for k in VEC_KEYS], row_tile=16,
        col_tile=16, interpret=True, mxu_dtype=jnp.float32, cross=cross,
        **kw)) for s, cross in ((d, False), (e, True)))
    out = K.edge_vector_reduce_pair(*pair_args(d, e), **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def v3b_dynamics():
    from diffndm_tpu_torch import config as tcfg
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.models.dynamics import EGNNDynamics

    cfg = tcfg.model_config_from_yaml(
        tcfg.load_yaml(os.path.join(RUN, "hparams.yaml")))
    model = EGNNDynamics(cfg.egnn, cfg.atom_nf, cfg.residue_nf)
    with np.load(NPZ) as f:
        model.load_state_dict(params_from_jax({k: f[k] for k in f.files}),
                              strict=True)
    return cfg, model.eval()


def test_v3b_forward_through_the_pair_equals_two_calls(monkeypatch):
    """The full-width v3b denoiser takes the pair entry for its coordinate
    update; routed through two single calls instead it gives the same
    bits."""
    cfg, model = v3b_dynamics()
    rng = np.random.default_rng(31)
    b, nl, npk = 2, 8, 16
    nf = cfg.atom_nf

    def t(arr):
        return torch.from_numpy(np.asarray(arr, np.float32))

    lm, pm = np.ones((b, nl), np.float32), np.ones((b, npk), np.float32)
    lm[1, 5:] = 0
    args = [t(rng.normal(size=(b, nl, 3 + nf)) * lm[..., None]),
            t(rng.normal(size=(b, npk, 3 + cfg.residue_nf)) * 2),
            t([0.3, 0.8]), t(lm), t(pm)]
    calls = []

    def two_calls(a, b_, d2c, d2i, adj, x, center, we, w2, b2, wout, **kw):
        calls.append(kw)
        return sum(K.edge_vector_reduce(a[s], b_[s], d2c, d2i, adj, x,
                                        center, we[s], w2[s], b2[s], wout[s],
                                        cross=bool(s), **kw) for s in (0, 1))

    with torch.no_grad():
        through_pair = model(*args)
        monkeypatch.setattr(K, "edge_vector_reduce_pair", two_calls)
        through_two = model(*args)
    assert len(calls) == cfg.egnn.n_layers
    for p, q in zip(through_pair, through_two):
        assert torch.isfinite(p).all() and torch.equal(p, q)


def edge_l2(layer):
    with np.load(NPZ) as f:
        return f[f"params/egnn/e_block_{layer}/gcl_0/edge_l2_kernel"]


def seeded_z(layer, rows=512):
    """silu of seeded pre-activations: what the kernels multiply by W2."""
    pre = (np.random.default_rng(layer).normal(size=(rows, 192)) * 1.5
           ).astype(np.float32)
    return (pre / (1 + np.exp(-pre))).astype(np.float32)


def test_tf32_round_is_round_to_nearest_on_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -1.0 - 2.0 ** -11, 3.0e-5, 0.0])
    r = K.tf32_round(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    # ties go away from zero, as cvt.rna.tf32.f32 rounds
    assert r.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                              -1.0 - 2.0 ** -10]
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)


@pytest.mark.parametrize("layer", range(5))
def test_three_term_tf32_split_keeps_fp32_accuracy(layer):
    """z @ W2 as big*small + small*big + big*big of TF32-rounded parts,
    accumulated in fp32, on the v3b weights at H=192: its error against
    float64 stays within twice that of the plain fp32 product, and inside
    the gate the kernels are held to."""
    z, w = seeded_z(layer), edge_l2(layer)
    ref = z.astype(np.float64) @ w.astype(np.float64)
    fp32_err = np.abs(z @ w - ref)
    zs, ws = (K.tf32_split(torch.from_numpy(v)) for v in (z, w))
    three = ((zs[..., 0] @ ws[..., 1] + zs[..., 1] @ ws[..., 0])
             + zs[..., 0] @ ws[..., 0]).numpy()
    err = np.abs(three - ref)
    assert err.mean() <= 2 * fp32_err.mean()
    assert err.max() <= 2 * fp32_err.max()
    assert np.all(err <= GATE_ATOL + GATE_RTOL * np.abs(ref))


@pytest.mark.parametrize("layer", range(5))
def test_single_pass_tf32_breaks_the_gate(layer):
    """Why the split: one TF32 product of the same operands misses
    atol 1e-5 + rtol 1e-4 on most elements."""
    z, w = seeded_z(layer), edge_l2(layer)
    ref = z.astype(np.float64) @ w.astype(np.float64)
    one = (K.tf32_round(torch.from_numpy(z))
           @ K.tf32_round(torch.from_numpy(w))).numpy()
    bad = np.abs(one - ref) > GATE_ATOL + GATE_RTOL * np.abs(ref)
    assert bad.mean() > 0.5


def test_pack_w2_layout():
    """[H/16, 16, H+4, 2]: row 16c + 4i + j of the split at [c, 4j + i],
    four zero pairs of padding per row."""
    w = torch.from_numpy(edge_l2(0))
    packed, split = K.pack_w2(w), K.tf32_split(w)
    assert packed.shape == (12, 16, 196, 2) and packed.is_contiguous()
    assert torch.all(packed[:, :, 192:] == 0)
    for k in range(192):
        c, r = divmod(k, 16)
        i, j = divmod(r, 4)
        assert torch.equal(packed[c, 4 * j + i, :192], split[k])
    # the two parts miss the weight by the remainder's own rounding only
    assert torch.all((split.sum(-1) - w).abs() <= w.abs() * 2.0 ** -21)


def test_split_cache_follows_the_weight():
    """One packing per weight tensor; a weight updated in place, or another
    tensor, is packed anew."""
    w = torch.from_numpy(edge_l2(1).copy())
    first = K.split_w2(w)
    assert K.split_w2(w) is first
    w.mul_(0.5)                               # bumps the version counter
    second = K.split_w2(w)
    assert second is not first
    assert torch.equal(second, K.pack_w2(w))
    assert K.split_w2(w) is second
    other = w.clone()
    assert K.split_w2(other) is not second
    assert torch.equal(K.split_w2(other), second)
    for _ in range(K._SPLIT_CACHE_SIZE + 5):   # the cache stays bounded
        K.split_w2(torch.zeros(16, 16))
    assert len(K._SPLIT_CACHE) <= K._SPLIT_CACHE_SIZE


@pytest.mark.parametrize("fault,error", [
    ("dtype", TypeError), ("contiguity", ValueError), ("shape", ValueError),
    ("hidden", ValueError), ("alignment", ValueError), ("nodes", ValueError)])
def test_kernel_input_checks(fault, error):
    """What the CUDA wrappers refuse before a launch (the checks do not
    depend on the device, so they run here on CPU tensors)."""
    h = 128 if fault != "hidden" else 96
    n = 16 if fault != "nodes" else K.MAX_NODES + 1
    d = {k: torch.zeros(s) for k, s in K._shapes(2, 16, h).items()}
    if fault == "dtype":
        d["adj"] = d["adj"].double()
    elif fault == "contiguity":
        d["d2c"] = d["d2c"].transpose(1, 2)
    elif fault == "shape":
        d["w2"] = torch.zeros(h, h + 1)
    elif fault == "alignment":
        d["b2"] = torch.zeros(h + 1)[1:]
    with pytest.raises(error):
        K._hidden_ok("gcl_messages", h, n)
        K._check_cuda("gcl_messages", {k: d[k] for k in GCL_KEYS},
                      K._shapes(2, 16, h))


def test_input_check_returns_the_addresses():
    d = {k: torch.zeros(s) for k, s in K._shapes(2, 16, 128).items()}
    ptrs = K._check_cuda("gcl_messages", {k: d[k] for k in GCL_KEYS},
                         K._shapes(2, 16, 128))
    assert ptrs == {k: d[k].data_ptr() for k in GCL_KEYS}


def test_pair_wants_pairs():
    d = make_inputs(1, 9, seed=6)
    args = pair_args(d, d)
    args[8] = args[8][:1]                     # one w2 only
    with pytest.raises(ValueError, match="pair of tensors"):
        K.edge_vector_reduce_pair(*args)


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel or raises (here: 'meta',
    which no kernel takes)."""
    d = make_inputs(1, 9, seed=4)
    args = [t.to("meta") for t in as_torch(d, GCL_KEYS)]
    with pytest.raises(ValueError, match="unsupported device"):
        K.gcl_messages(*args)
    args = [t.to("meta") for t in as_torch(d, VEC_KEYS)]
    with pytest.raises(ValueError, match="unsupported device"):
        K.edge_vector_reduce(*args)
    args = [tuple(t.to("meta") for t in a) if isinstance(a, tuple)
            else a.to("meta") for a in pair_args(d, d)]
    with pytest.raises(ValueError, match="unsupported device"):
        K.edge_vector_reduce_pair(*args)
