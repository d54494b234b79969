"""The backward of the port's EGNN edge-chain functions.

The JAX package's Pallas kernels have no VJP: its trainer differentiates
the dense XLA path of ``diffndm_tpu/models/egnn.py``.  The port computes
the same gradient with a ``torch.autograd.Function`` per wrapper whose
backward is a hand-written CUDA kernel on the card and, on the CPU, the
plain backward (``*_backward_plain``) that writes the formula out.  Here:

- the plain backward equals ``torch.autograd.grad`` through the plain
  forward, in float64 (so any difference is a wrong formula, not
  rounding): attention on and off, ``batt`` None, the difference and
  cross direction, tanh on and off, ``n_rows`` None / 13 / 0, the pair;
- it equals ``jax.vjp`` of the JAX dense chain (the double ``where``
  guard of the cross norm included) on the same numpy inputs in fp32,
  within atol 1e-5 + rtol 1e-4 of each tensor's largest entry (sums over
  every edge, taken in another order);
- ``torch.autograd.gradcheck`` in float64 on each Function;
- the Function returns None for every input it is not asked about, and
  row chunking of the plain backward changes only the blocking.

The CUDA kernels themselves are held against the plain backward on the
card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu.models.egnn import coord_diff  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
GCL_KEYS = ("a", "b", "d2c", "d2i", "adj", "we", "w2", "b2", "watt", "batt")
VEC_KEYS = ("a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
            "wout")
SET_KEYS = ("a", "b", "we", "w2", "b2", "wout")


def make_inputs(b, n, h, seed, dtype=np.float32):
    """Seeded inputs; adj keeps the diagonal (self-edges, as the model
    does) and mixes in 0.5 entries."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)) * 2
    x0 = rng.normal(size=(b, n, 3)) * 2
    adj = (rng.uniform(size=(b, n, n)) > 0.3) * np.where(
        rng.uniform(size=(b, n, n)) > 0.8, 0.5, 1.0)
    adj[:, np.arange(n), np.arange(n)] = 1.0
    d = dict(
        a=rng.normal(size=(b, n, h)), b=rng.normal(size=(b, n, h)),
        d2c=((x[:, :, None] - x[:, None]) ** 2).sum(-1),
        d2i=((x0[:, :, None] - x0[:, None]) ** 2).sum(-1), adj=adj,
        we=rng.normal(size=(2, h)) * 0.2, w2=rng.normal(size=(h, h)) * 0.3,
        b2=rng.normal(size=(h,)) * 0.1, watt=rng.normal(size=(h, 1)) * 0.3,
        batt=rng.normal(size=(1,)) * 0.1, wout=rng.normal(size=(h, 1)) * 0.3,
        x=x, center=x.mean(axis=1, keepdims=True))
    return {k: v.astype(dtype) for k, v in d.items()}


def torch_args(d, keys, grad=True):
    return [torch.from_numpy(d[k]).requires_grad_(grad and k != "adj")
            for k in keys]


def assert_grads(got, ref, names, rtol, atol):
    """Per tensor: max |got - ref| <= atol + rtol * max |ref|.  A weight's
    gradient is a sum over every edge of the batch, and where its terms
    cancel an element's own relative error says nothing; the tensor's
    scale does (the gate chip_smoke.py holds the CUDA backward to)."""
    for name, g, r in zip(names, got, ref):
        if r is None:
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        r = np.asarray(r)
        assert g.shape == r.shape, name
        err = float(np.abs(g - r).max()) if r.size else 0.0
        lim = atol + rtol * (float(np.abs(r).max()) if r.size else 0.0)
        assert np.isfinite(g).all() and err <= lim, (name, err, lim)


# -- against torch autograd through the plain forward, float64 ------------

@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("with_batt", [True, False])
def test_gcl_plain_backward_equals_autograd(attention, with_batt):
    d = make_inputs(2, 13, 16, seed=1, dtype=np.float64)
    args = torch_args(d, GCL_KEYS)
    if not with_batt:
        args[-1] = None
    out = K.gcl_messages_plain(*args, attention=attention)
    gout = torch.from_numpy(np.random.default_rng(2).normal(
        size=out.shape))
    wrt = [t for t in args if t is not None and t.requires_grad]
    ref = torch.autograd.grad(out, wrt, gout, allow_unused=True)
    got = K.gcl_messages_backward_plain(
        gout, *[None if t is None else t.detach() for t in args],
        attention=attention)
    assert got[4] is None and (got[9] is None) == (not with_batt)
    got = [g for g, t in zip(got, args) if t is not None and t.requires_grad]
    ref = [torch.zeros_like(t) if r is None else r
           for r, t in zip(ref, wrt)]
    assert_grads(got, ref, [k for k, t in zip(GCL_KEYS, args)
                            if t is not None and t.requires_grad],
                 1e-10, 1e-12)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 13, 0])
def test_vec_plain_backward_equals_autograd(cross, tanh, n_rows):
    d = make_inputs(2, 17, 16, seed=3, dtype=np.float64)
    args = torch_args(d, VEC_KEYS)
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0, cross=cross,
              norm_factor=100.0, n_rows=n_rows)
    out = K.edge_vector_reduce_plain(*args, **kw)
    gout = torch.from_numpy(np.random.default_rng(4).normal(
        size=out.shape))
    got = K.edge_vector_reduce_backward_plain(
        gout, *[t.detach() for t in args], **kw)
    assert got[4] is None
    if n_rows == 0:      # nothing is computed: every gradient is 0
        assert out.grad_fn is None
        assert all(float(g.abs().max()) == 0.0 for g in got if g is not None)
        return
    wrt = [t for t in args if t.requires_grad]
    # the difference direction does not read the centre
    ref = [torch.zeros_like(t) if r is None else r for r, t in zip(
        torch.autograd.grad(out, wrt, gout, allow_unused=True), wrt)]
    assert_grads([g for g, t in zip(got, args) if t.requires_grad], ref,
                 [k for k in VEC_KEYS if k != "adj"], 1e-10, 1e-12)


@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 11])
def test_pair_plain_backward_equals_autograd(tanh, n_rows):
    d = make_inputs(2, 15, 16, seed=5, dtype=np.float64)
    e = make_inputs(2, 15, 16, seed=6, dtype=np.float64)
    two = {k: (torch.from_numpy(d[k]).requires_grad_(),
               torch.from_numpy(e[k]).requires_grad_()) for k in SET_KEYS}
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"))
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0,
              norm_factor=100.0, n_rows=n_rows)
    args = [two["a"], two["b"], *shared, two["we"], two["w2"], two["b2"],
            two["wout"]]
    out = K.edge_vector_reduce_pair_plain(*args, **kw)
    gout = torch.from_numpy(np.random.default_rng(7).normal(size=out.shape))
    got = K.edge_vector_reduce_pair_backward_plain(gout, *[
        tuple(t.detach() for t in a) if isinstance(a, tuple) else a.detach()
        for a in args], **kw)
    names = ["a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
             "wout"]
    flat_args, flat_got, flat_names = [], [], []
    for name, a, g in zip(names, args, got):
        if name == "adj":
            assert g is None
            continue
        if isinstance(a, tuple):
            flat_args += list(a)
            flat_got += list(g)
            flat_names += [f"{name}[0]", f"{name}[1]"]
        else:
            flat_args.append(a)
            flat_got.append(g)
            flat_names.append(name)
    ref = torch.autograd.grad(out, flat_args, gout)
    assert_grads(flat_got, ref, flat_names, 1e-10, 1e-12)


# -- against jax.vjp of the JAX dense chain, fp32 --------------------------

def jax_messages(a, b, d2c, d2i, we, w2, b2):
    z = jax.nn.silu(a[:, :, None, :] + b[:, None, :, :]
                    + d2c[..., None] * we[0] + d2i[..., None] * we[1])
    return jax.nn.silu(z @ w2 + b2)


def jax_gcl(attention, a, b, d2c, d2i, adj, we, w2, b2, watt, batt):
    m = jax_messages(a, b, d2c, d2i, we, w2, b2)
    if attention:
        m = m * jax.nn.sigmoid(m @ watt + batt)
    return jnp.sum(m * adj[..., None], axis=2) / 100.0


def jax_vec(cross, tanh, n_rows, a, b, d2c, d2i, adj, x, center, we, w2, b2,
            wout):
    """The JAX dense path's coordinate chain (models/egnn.py), the cross
    norm under its double where."""
    phi = jax_messages(a, b, d2c, d2i, we, w2, b2) @ wout
    if tanh:
        phi = jnp.tanh(phi) * 15.0
    if cross:
        ctr = center[:, :, None, :]
        cr = jnp.cross(x[:, :, None, :] - ctr, x[:, None, :, :] - ctr)
        n2 = jnp.sum(cr * cr, axis=-1, keepdims=True)
        norm = jnp.where(n2 > 0, jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
        v = cr / (norm + 1.0)
    else:
        _, v = coord_diff(x[:, :, None, :], x[:, None, :, :], 1.0)
    out = jnp.sum(v * phi * adj[..., None], axis=2) / 100.0
    rows = x.shape[1] if n_rows is None else n_rows
    return out * (jnp.arange(x.shape[1]) < rows)[None, :, None]


def jax_grads(fn, d, keys, gout):
    """jax.vjp of fn with respect to every argument but adj."""
    args = [jnp.asarray(d[k]) for k in keys]
    i_adj = keys.index("adj")

    def f(*free):
        full = list(free[:i_adj]) + [args[i_adj]] + list(free[i_adj:])
        return fn(*full)

    free = args[:i_adj] + args[i_adj + 1:]
    _, vjp = jax.vjp(f, *free)
    return [np.asarray(g) for g in vjp(jnp.asarray(gout))]


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_plain_backward_matches_jax_vjp(attention):
    d = make_inputs(2, 37, 32, seed=11)
    gout = np.random.default_rng(12).normal(size=(2, 37, 32)).astype(
        np.float32)
    ref = jax_grads(lambda *a: jax_gcl(attention, *a), d, GCL_KEYS, gout)
    got = K.gcl_messages_backward_plain(torch.from_numpy(gout),
                                        *torch_args(d, GCL_KEYS, False),
                                        attention=attention)
    got = [g for k, g in zip(GCL_KEYS, got) if k != "adj"]
    assert_grads(got, ref, [k for k in GCL_KEYS if k != "adj"], RTOL, ATOL)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 13, 0])
def test_vec_plain_backward_matches_jax_vjp(cross, tanh, n_rows):
    d = make_inputs(2, 37, 32, seed=13)
    gout = np.random.default_rng(14).normal(size=(2, 37, 3)).astype(
        np.float32)
    ref = jax_grads(lambda *a: jax_vec(cross, tanh, n_rows, *a), d,
                    VEC_KEYS, gout)
    got = K.edge_vector_reduce_backward_plain(
        torch.from_numpy(gout), *torch_args(d, VEC_KEYS, False), tanh=tanh,
        coords_range=15.0, norm_constant=1.0, cross=cross,
        norm_factor=100.0, n_rows=n_rows)
    got = [g for k, g in zip(VEC_KEYS, got) if k != "adj"]
    assert_grads(got, ref, [k for k in VEC_KEYS if k != "adj"], RTOL, ATOL)


@pytest.mark.parametrize("n_rows", [None, 13])
def test_pair_plain_backward_matches_jax_vjp(n_rows):
    d, e = make_inputs(2, 37, 32, seed=15), make_inputs(2, 37, 32, seed=16)
    gout = np.random.default_rng(17).normal(size=(2, 37, 3)).astype(
        np.float32)
    keys = ("a0", "a1", "b0", "b1", "d2c", "d2i", "adj", "x", "center",
            "we0", "we1", "w20", "w21", "b20", "b21", "wout0", "wout1")
    both = {**{k: d[k] for k in ("d2c", "d2i", "adj", "x", "center")},
            **{f"{k}{s}": (d, e)[s][k] for k in SET_KEYS for s in (0, 1)}}

    def pair(a0, a1, b0, b1, d2c, d2i, adj, x, center, we0, we1, w20, w21,
             b20, b21, wout0, wout1):
        return (jax_vec(False, True, n_rows, a0, b0, d2c, d2i, adj, x,
                        center, we0, w20, b20, wout0)
                + jax_vec(True, True, n_rows, a1, b1, d2c, d2i, adj, x,
                          center, we1, w21, b21, wout1))

    ref = dict(zip([k for k in keys if k != "adj"],
                   jax_grads(pair, both, keys, gout)))
    t = {k: torch.from_numpy(v) for k, v in both.items()}
    got = K.edge_vector_reduce_pair_backward_plain(
        torch.from_numpy(gout), (t["a0"], t["a1"]), (t["b0"], t["b1"]),
        t["d2c"], t["d2i"], t["adj"], t["x"], t["center"],
        (t["we0"], t["we1"]), (t["w20"], t["w21"]), (t["b20"], t["b21"]),
        (t["wout0"], t["wout1"]), n_rows=n_rows)
    names = ["a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
             "wout"]
    for name, g in zip(names, got):
        if name == "adj":
            continue
        if isinstance(g, tuple):
            assert_grads(g, [ref[f"{name}0"], ref[f"{name}1"]],
                         [f"{name}0", f"{name}1"], RTOL, ATOL)
        else:
            assert_grads([g], [ref[name]], [name], RTOL, ATOL)


# -- the Functions ---------------------------------------------------------

def test_gradcheck_gcl_function():
    d = make_inputs(1, 6, 4, seed=21, dtype=np.float64)
    args = torch_args(d, GCL_KEYS)
    assert torch.autograd.gradcheck(
        lambda *a: K.gcl_messages(*a, attention=True), args, eps=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("cross", [False, True])
def test_gradcheck_vec_function(cross):
    d = make_inputs(1, 6, 4, seed=22, dtype=np.float64)
    args = torch_args(d, VEC_KEYS)
    assert torch.autograd.gradcheck(
        lambda *a: K.edge_vector_reduce(*a, cross=cross, n_rows=4), args,
        eps=1e-6, atol=1e-7)


def test_gradcheck_pair_function():
    d = make_inputs(1, 6, 4, seed=23, dtype=np.float64)
    e = make_inputs(1, 6, 4, seed=24, dtype=np.float64)
    flat = [torch.from_numpy(v).requires_grad_()
            for k in SET_KEYS for v in (d[k], e[k])]
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"))

    inputs = flat + [shared[3], shared[4]]
    assert torch.autograd.gradcheck(
        lambda *f: K.edge_vector_reduce_pair(
            (f[0], f[1]), (f[2], f[3]), *shared[:3], f[12], f[13],
            (f[4], f[5]), (f[6], f[7]), (f[8], f[9]), (f[10], f[11]),
            n_rows=5), inputs, eps=1e-6, atol=1e-7)


@pytest.mark.parametrize("wanted", [("w2",), ("a", "d2c"), ("watt", "batt"),
                                    ("b", "we", "b2")])
def test_gcl_function_returns_none_where_not_asked(wanted):
    d = make_inputs(1, 7, 8, seed=25)
    args = [torch.from_numpy(d[k]).requires_grad_(k in wanted)
            for k in GCL_KEYS]
    with torch.enable_grad():
        out = K.gcl_messages(*args)
    grads = out.grad_fn.apply(torch.ones_like(out))
    # the tensors, then attention, norm_factor and compute_dtype
    assert len(grads) == 13
    for k, g in zip(GCL_KEYS, grads):
        assert (g is not None) == (k in wanted), k
    assert all(g is None for g in grads[10:])


@pytest.mark.parametrize("wanted", [("x", "center"), ("w2",),
                                    ("d2c", "wout")])
def test_vec_function_returns_none_where_not_asked(wanted):
    d = make_inputs(1, 7, 8, seed=26)
    args = [torch.from_numpy(d[k]).requires_grad_(k in wanted)
            for k in VEC_KEYS]
    with torch.enable_grad():
        out = K.edge_vector_reduce(*args, cross=True)
    grads = out.grad_fn.apply(torch.ones_like(out))
    # (options, d2c, d2i, adj, x, center, a, b, we, w2, b2, wout)
    order = ("opts", "d2c", "d2i", "adj", "x", "center", *SET_KEYS)
    assert len(grads) == len(order)
    for k, g in zip(order, grads):
        assert (g is not None) == (k in wanted), k


def test_plain_backward_row_chunking_agrees(monkeypatch):
    d = make_inputs(2, 23, 16, seed=27)
    gout = torch.from_numpy(np.random.default_rng(28).normal(
        size=(2, 23, 16)).astype(np.float32))
    vout = gout[..., :3].contiguous()
    full = K.gcl_messages_backward_plain(gout, *torch_args(d, GCL_KEYS,
                                                           False))
    vfull = K.edge_vector_reduce_backward_plain(
        vout, *torch_args(d, VEC_KEYS, False), cross=True, n_rows=17)
    monkeypatch.setattr(K, "_PLAIN_CHUNK_ELEMS", 8 * 2 * 23 * 16 * 3)
    part = K.gcl_messages_backward_plain(gout, *torch_args(d, GCL_KEYS,
                                                           False))
    vpart = K.edge_vector_reduce_backward_plain(
        vout, *torch_args(d, VEC_KEYS, False), cross=True, n_rows=17)
    names = [f"gcl {k}" for k in GCL_KEYS] + [f"vec {k}" for k in VEC_KEYS]
    assert_grads(part + vpart, [None if a is None else a.numpy()
                                for a in full + vfull], names, 1e-5, 1e-6)
