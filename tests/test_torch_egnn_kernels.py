"""The port's plain EGNN edge-chain functions against the JAX Pallas
kernels they replace (interpret mode on the CPU, fp32 matrix unit).

Both sides compute in fp32 and differ only in the order of their sums,
so the tolerance is rtol 1e-5, atol 1e-6.  On the CPU the port's
wrappers take the plain path; that they do so only for CPU tensors is
checked too.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from diffndm_tpu.ops import pallas_egnn as PK  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
H = 32


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


def test_cpu_wrappers_take_the_plain_path_and_count_nothing():
    d = make_inputs(1, 9, seed=3)
    K.reset_launches()
    K.gcl_messages(*as_torch(d, GCL_KEYS))
    K.edge_vector_reduce(*as_torch(d, VEC_KEYS))
    assert K.LAUNCHES == {"gcl_messages": 0, "edge_vector_reduce": 0}


@pytest.mark.parametrize("fault,error", [
    ("dtype", TypeError), ("contiguity", ValueError), ("shape", ValueError),
    ("hidden", ValueError)])
def test_kernel_input_checks(fault, error):
    """What the CUDA wrappers refuse before a launch (the checks do not
    depend on the device, so they run here on CPU tensors)."""
    h = 128 if fault != "hidden" else 96
    d = {k: torch.zeros(s) for k, s in K._shapes(2, 16, h).items()}
    if fault == "dtype":
        d["adj"] = d["adj"].double()
    elif fault == "contiguity":
        d["d2c"] = d["d2c"].transpose(1, 2)
    elif fault == "shape":
        d["w2"] = torch.zeros(h, h + 1)
    with pytest.raises(error):
        K._hidden_ok("gcl_messages", h)
        K._check_cuda("gcl_messages", {k: d[k] for k in GCL_KEYS},
                      K._shapes(2, 16, h))


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
