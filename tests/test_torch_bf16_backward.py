"""The backward of the port's bf16 edge chains, on the CPU.

``compute_dtype = "bfloat16"`` rounds the Pallas kernels' product
operands to bf16 (``mxu_dtype``).  Its gradient is the VJP of that
arithmetic under the cast rule that ``jax.vjp`` and torch autograd share:
a cotangent is rounded to bf16 where the forward rounded an operand (the
gradient of silu(u1) after du W2'^T, that of bf16(m) in the gate or phi
dot), and the weights' cotangents (W2, watt, wout) are summed in fp32 over
the call and rounded once.  The plain backward writes it out
(``*_backward_plain(..., compute_dtype="bfloat16")``); the card's bf16
backward kernel is held to it by ``chip_smoke.py --only bf16train``.
Held here:

- (a) the written-out bf16 backward equals ``torch.autograd.grad``
  through the plain bf16 forward, in float64 (so that a wrong rounding
  point shows, and no fp32 sum order moves a rounding): attention on and
  off, with and without batt, the difference and cross directions, tanh
  on and off, ``n_rows`` None / 13 / 0, the pair; tolerance 1e-10 of each
  tensor's largest entry + 1e-12, which the fp32 plain backward on the
  same inputs misses;
- the repair: the plain bf16 forward rounds W2, watt and wout once per
  call, so their autograd gradients are bf16 values that do not depend
  on the row chunking, and its values are those of a forward that rounds
  them per chunk;
- (b) the written-out bf16 backward against ``jax.vjp`` of a jnp
  transcription of the Pallas bodies' bf16 arithmetic (``_gcl_kernel``,
  ``_vec_kernel``: the casts to bfloat16, the dots with
  ``preferred_element_type=float32``) in fp32; the transcription's
  forward is held to the Pallas kernels in interpret mode at
  PALLAS_RTOL / PALLAS_ATOL.  Two fp32 programs can
  round a value that sits at a bf16 midpoint to either side, so the gate
  is that of the card's kernel (``bf16_gate``): every unrounded gradient
  within BF16_BWD_L2 of the reference in relative L2 norm, the rounded
  weight gradients bf16 values within one bf16 step of the reference's.
  The fp32 plain backward fails it;
- (c) the Functions in bf16 return None where no gradient is asked, and
  launch nothing on the CPU;
- (d) two bf16 ``Trainer`` micro-steps at hidden 32 and 2 layers against
  the JAX bf16 ``Trainer`` on the same weights, rows, t and noise: loss
  and gradient norm within TRAINER_RTOL.  This guards the wiring only
  (the bf16 config reaches the kernels' bf16 forward and backward, and
  the step runs): JAX's trainer differentiates its dense XLA path, which
  computes z in bf16 arithmetic and never rounds W2, so it lies as close
  to the port's fp32 gradient as to its bf16 one.

Torch runs on one thread (the ROADMAP's ground rules).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from diffndm_tpu import config as jcfg  # noqa: E402
from diffndm_tpu.constants import dataset_params as jparams  # noqa: E402
from diffndm_tpu.data import dataset as jdata  # noqa: E402
from diffndm_tpu.diffusion import core as jcore  # noqa: E402
from diffndm_tpu.diffusion import schedules as jS  # noqa: E402
from diffndm_tpu.models.dynamics import EGNNDynamics as JaxDynamics  # noqa: E402
from diffndm_tpu.models.egnn import coord_diff  # noqa: E402
from diffndm_tpu.ops import pallas_egnn as PK  # noqa: E402
from diffndm_tpu.parallel.mesh import make_mesh  # noqa: E402
from diffndm_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from diffndm_tpu_torch.diffusion import core as tcore  # noqa: E402
from diffndm_tpu_torch.diffusion import schedules as tS  # noqa: E402
from diffndm_tpu_torch.models.dynamics import EGNNDynamics  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402
from diffndm_tpu_torch.structs import NodeBatch  # noqa: E402
from diffndm_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_egnn_backward import (GCL_KEYS, SET_KEYS, VEC_KEYS,  # noqa: E402
                                      assert_grads, jax_grads, make_inputs,
                                      torch_args)

BF, F32 = jnp.bfloat16, jnp.float32
BF16 = "bfloat16"
F64_RTOL, F64_ATOL = 1e-10, 1e-12
# the gate of a bf16 backward against another program's (chip_smoke.py's
# BF16_BWD_L2, ``bf16_gate``; on the card it is widened to twice the
# plain fp32 backward's own distance where a sum cancels, here it is the
# L2 bound alone): the relative L2 norm of the difference per
# gradient; the gradients that the backward rounds once per call
# (ROUNDED) bf16 values.  Two programs' fp32 sums and transcendentals
# differ in their last bits, and where a value sits near a bf16 midpoint
# that rounds it the other way, by 2^-8 of itself, and every gradient
# downstream of it moves: on these inputs JAX's transcription and the
# plain backward lie up to 0.36 of the gate apart, the fp32 plain backward
# 2.2 of it or more on some gradient of every case
BF16_BWD_L2 = 2.5e-3
# the weights whose gradients the bf16 backward rounds once per call
ROUNDED = ("w2", "watt", "wout")
# (b)'s transcription against the Pallas kernels in interpret mode: the
# gate of test_torch_bf16.py's port-against-Pallas bf16 forwards, max
# |transcription - Pallas| <= KERNEL_GATE max |Pallas| (a value at a bf16
# midpoint may round the other way), which the Pallas kernels with fp32
# operands miss by four times
KERNEL_GATE = 2e-4
# (d): seen 4.4e-5 (loss) and 1.3e-3 (gradient norm) apart; the port's
# fp32 step lies 9e-6 and 1.0e-4 from JAX's bf16 one
TRAINER_RTOL = 5e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_gate(got, ref, names):
    """(worst share of the gate, passes): each gradient within BF16_BWD_L2
    of ``ref`` in relative L2 norm; those in ROUNDED bf16 values, where an
    element one bf16 step from the reference's (the final rounding gone
    the other way) is taken as agreeing."""
    worst, ok = 0.0, True
    for name, g, r in zip(names, got, ref):
        if r is None:
            continue
        g = g.detach() if isinstance(g, torch.Tensor) else torch.from_numpy(g)
        r = torch.from_numpy(np.array(r, dtype=np.float32))
        ok = ok and bool(torch.isfinite(g).all())
        diff = g - r
        if name.rstrip("01") in ROUNDED:
            ok = ok and torch.equal(K.bf16_round(g), g)
            big = torch.maximum(g.abs(), r.abs()).clamp_min(1e-30)
            step = torch.exp2(torch.floor(torch.log2(big)) - 7)
            diff = torch.where(diff.abs() <= step, 0.0, diff)
        norm = float(r.norm())
        share = (float(diff.norm()) / norm / BF16_BWD_L2 if norm
                 else 2.0 * float(g.abs().max() > 0))
        ok = ok and share <= 1.0
        worst = max(worst, share)
    return worst, ok


# -- (a) against autograd through the plain bf16 forward, float64 ---------

def gcl_case(attention, with_batt, compute_dtype):
    d = make_inputs(2, 13, 16, seed=31, dtype=np.float64)
    args = torch_args(d, GCL_KEYS)
    if not with_batt:
        args[-1] = None
    out = K.gcl_messages_plain(*args, attention=attention,
                               compute_dtype=BF16)
    gout = torch.from_numpy(np.random.default_rng(32).normal(size=out.shape))
    wrt = [t for t in args if t is not None and t.requires_grad]
    ref = [torch.zeros_like(t) if r is None else r for r, t in zip(
        torch.autograd.grad(out, wrt, gout, allow_unused=True), wrt)]
    got = K.gcl_messages_backward_plain(
        gout, *[None if t is None else t.detach() for t in args],
        attention=attention, compute_dtype=compute_dtype)
    assert got[4] is None and (got[9] is None) == (not with_batt)
    names = [k for k, t in zip(GCL_KEYS, args)
             if t is not None and t.requires_grad]
    return [g for g, t in zip(got, args)
            if t is not None and t.requires_grad], ref, names


@pytest.mark.parametrize("attention", [True, False])
@pytest.mark.parametrize("with_batt", [True, False])
def test_gcl_bf16_plain_backward_equals_autograd(attention, with_batt):
    got, ref, names = gcl_case(attention, with_batt, BF16)
    assert_grads(got, ref, names, F64_RTOL, F64_ATOL)
    fp32, _, _ = gcl_case(attention, with_batt, "float32")
    with pytest.raises(AssertionError):
        assert_grads(fp32, ref, names, F64_RTOL, F64_ATOL)


def vec_case(cross, tanh, n_rows, compute_dtype):
    d = make_inputs(2, 17, 16, seed=33, dtype=np.float64)
    args = torch_args(d, VEC_KEYS)
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0, cross=cross,
              norm_factor=100.0, n_rows=n_rows)
    out = K.edge_vector_reduce_plain(*args, **kw, compute_dtype=BF16)
    gout = torch.from_numpy(np.random.default_rng(34).normal(size=out.shape))
    got = K.edge_vector_reduce_backward_plain(
        gout, *[t.detach() for t in args], **kw, compute_dtype=compute_dtype)
    assert got[4] is None
    return out, got, args, gout


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 13, 0])
def test_vec_bf16_plain_backward_equals_autograd(cross, tanh, n_rows):
    out, got, args, gout = vec_case(cross, tanh, n_rows, BF16)
    if n_rows == 0:      # nothing is computed: every gradient is 0
        assert out.grad_fn is None
        assert all(float(g.abs().max()) == 0.0 for g in got if g is not None)
        return
    wrt = [t for t in args if t.requires_grad]
    ref = [torch.zeros_like(t) if r is None else r for r, t in zip(
        torch.autograd.grad(out, wrt, gout, allow_unused=True), wrt)]
    names = [k for k in VEC_KEYS if k != "adj"]
    sel = [g for g, t in zip(got, args) if t.requires_grad]
    assert_grads(sel, ref, names, F64_RTOL, F64_ATOL)
    _, fp32, _, _ = vec_case(cross, tanh, n_rows, "float32")
    with pytest.raises(AssertionError):
        assert_grads([g for g, t in zip(fp32, args) if t.requires_grad],
                     ref, names, F64_RTOL, F64_ATOL)


def pair_flat(args, got):
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
            flat_names += [f"{name}0", f"{name}1"]
        else:
            flat_args.append(a)
            flat_got.append(g)
            flat_names.append(name)
    return flat_args, flat_got, flat_names


@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 11])
def test_pair_bf16_plain_backward_equals_autograd(tanh, n_rows):
    d = make_inputs(2, 15, 16, seed=35, dtype=np.float64)
    e = make_inputs(2, 15, 16, seed=36, dtype=np.float64)
    two = {k: (torch.from_numpy(d[k]).requires_grad_(),
               torch.from_numpy(e[k]).requires_grad_()) for k in SET_KEYS}
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"))
    kw = dict(tanh=tanh, coords_range=15.0, norm_constant=1.0,
              norm_factor=100.0, n_rows=n_rows)
    args = [two["a"], two["b"], *shared, two["we"], two["w2"], two["b2"],
            two["wout"]]
    out = K.edge_vector_reduce_pair_plain(*args, **kw, compute_dtype=BF16)
    gout = torch.from_numpy(np.random.default_rng(37).normal(size=out.shape))
    detached = [tuple(t.detach() for t in a) if isinstance(a, tuple)
                else a.detach() for a in args]
    got = K.edge_vector_reduce_pair_backward_plain(gout, *detached, **kw,
                                                   compute_dtype=BF16)
    flat_args, flat_got, names = pair_flat(args, got)
    ref = torch.autograd.grad(out, flat_args, gout)
    assert_grads(flat_got, ref, names, F64_RTOL, F64_ATOL)
    fp32 = K.edge_vector_reduce_pair_backward_plain(gout, *detached, **kw)
    with pytest.raises(AssertionError):
        assert_grads(pair_flat(args, fp32)[1], ref, names, F64_RTOL,
                     F64_ATOL)


# -- the repair: weights rounded once per call ------------------------------

def weight_grads(monkeypatch, chunk_elems):
    """Autograd of the plain bf16 forwards, gcl and the pair, under a row
    chunk budget; their outputs and the gradients of W2, watt, wout."""
    monkeypatch.setattr(K, "_PLAIN_CHUNK_ELEMS", chunk_elems)
    d, e = make_inputs(2, 21, 32, seed=41), make_inputs(2, 21, 32, seed=42)
    gcl = torch_args(d, GCL_KEYS)
    out_g = K.gcl_messages_plain(*gcl, compute_dtype=BF16)
    two = {k: (torch.from_numpy(d[k]).requires_grad_(),
               torch.from_numpy(e[k]).requires_grad_()) for k in SET_KEYS}
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"))
    out_v = K.edge_vector_reduce_pair_plain(
        two["a"], two["b"], *shared, two["we"], two["w2"], two["b2"],
        two["wout"], n_rows=17, compute_dtype=BF16)
    rng = np.random.default_rng(43)
    gg = torch.from_numpy(rng.normal(size=out_g.shape).astype(np.float32))
    gv = torch.from_numpy(rng.normal(size=out_v.shape).astype(np.float32))
    wrt = [gcl[6], gcl[8], *two["w2"], *two["wout"]]
    grads = torch.autograd.grad([out_g, out_v], wrt, [gg, gv])
    return [out_g.detach(), out_v.detach()], grads


def test_bf16_weight_gradients_do_not_depend_on_the_chunking(monkeypatch):
    """One chunk of every row against one-row chunks: the forward values
    are equal, and the gradients of W2, watt and wout are equal and bf16
    values (each rounded once per call)."""
    outs, whole = weight_grads(monkeypatch, 1 << 24)
    outs1, rows = weight_grads(monkeypatch, 2 * 21 * 32)
    for a, b in zip(outs, outs1):
        assert torch.equal(a, b)
    for g, h in zip(whole, rows):
        assert torch.equal(g, h)
        assert torch.equal(K.bf16_round(g), g)
        assert float(g.abs().max()) > 0


def test_bf16_forward_values_as_rounded_per_chunk():
    """The forward is the one that rounded the weights per chunk: rounding
    is idempotent, so pre-rounded weights give the same bits."""
    d = make_inputs(2, 21, 32, seed=44)
    args = torch_args(d, GCL_KEYS, False)
    pre = list(args)
    for i in (6, 8):
        pre[i] = K.bf16_round(args[i])
    with torch.no_grad():
        assert torch.equal(K.gcl_messages_plain(*args, compute_dtype=BF16),
                           K.gcl_messages_plain(*pre, compute_dtype=BF16))


# -- (b) against jax.vjp of the Pallas bodies' bf16 arithmetic, fp32 -------

def jax_bf16_messages(a, b, d2c, d2i, we, w2, b2):
    """``_gcl_kernel`` / ``_vec_kernel`` up to m: z in fp32, its product
    by W2 on bf16 operands with an fp32 result."""
    z = jax.nn.silu(a[:, :, None, :] + b[:, None, :, :]
                    + d2c[..., None] * we[0] + d2i[..., None] * we[1])
    return jax.nn.silu(jnp.dot(z.astype(BF), w2.astype(BF),
                               preferred_element_type=F32) + b2)


def jax_bf16_gcl(attention, a, b, d2c, d2i, adj, we, w2, b2, watt, batt):
    m = jax_bf16_messages(a, b, d2c, d2i, we, w2, b2)
    if attention:
        m = m * jax.nn.sigmoid(jnp.dot(m.astype(BF), watt.astype(BF),
                                       preferred_element_type=F32) + batt)
    return jnp.sum(m * adj[..., None], axis=2) / 100.0


def jax_bf16_vec(cross, tanh, n_rows, a, b, d2c, d2i, adj, x, center, we,
                 w2, b2, wout):
    """``_vec_kernel``'s arithmetic; the cross norm under the JAX dense
    path's double where (the port's direction gradient: a self-edge's
    cross norm has none; the Pallas body has no VJP to compare)."""
    m = jax_bf16_messages(a, b, d2c, d2i, we, w2, b2)
    phi = jnp.dot(m.astype(BF), wout.astype(BF),
                  preferred_element_type=F32)
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


def assert_is_the_pallas_body(got, pallas, *args, **kw):
    """``got`` within KERNEL_GATE of the Pallas kernel in bf16, and four
    times that from the same kernel with fp32 operands (one tile per batch
    element: interpret mode's cost is per grid step)."""
    want = np.asarray(pallas(*args, **kw, row_tile=32, col_tile=32,
                             interpret=True, mxu_dtype=BF))
    fp32 = np.asarray(pallas(*args, **kw, row_tile=32, col_tile=32,
                             interpret=True, mxu_dtype=F32))
    scale = np.abs(want).max()
    got = np.asarray(got)
    assert np.abs(got - want).max() <= KERNEL_GATE * scale
    assert np.abs(got - fp32).max() > 4 * KERNEL_GATE * scale


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_transcription_is_the_pallas_body(attention):
    """The transcription's forward is ``PK.gcl_messages`` in bf16."""
    d = make_inputs(2, 29, 32, seed=51)
    args = [jnp.asarray(d[k]) for k in GCL_KEYS]
    assert_is_the_pallas_body(jax_bf16_gcl(attention, *args),
                              PK.gcl_messages, *args, attention=attention)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
def test_vec_transcription_is_the_pallas_body(cross, tanh):
    """The transcription's forward is ``PK.edge_vector_reduce`` in bf16
    (which has no n_rows: every row)."""
    d = make_inputs(2, 29, 32, seed=53)
    args = [jnp.asarray(d[k]) for k in VEC_KEYS]
    assert_is_the_pallas_body(jax_bf16_vec(cross, tanh, None, *args),
                              PK.edge_vector_reduce, *args, tanh=tanh,
                              cross=cross)


def assert_bf16_gate(got, ref, names):
    share, ok = bf16_gate(got, ref, names)
    assert ok, (names, share)
    return share


def assert_fails_bf16_gate(got, ref, names):
    """A control fails the gate on its unrounded gradients alone."""
    keep = [i for i, n in enumerate(names)
            if ref[i] is not None and n.rstrip("01") not in ROUNDED]
    share, ok = bf16_gate([got[i] for i in keep], [ref[i] for i in keep],
                          [names[i] for i in keep])
    assert not ok, share


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_bf16_plain_backward_matches_jax_vjp(attention):
    d = make_inputs(2, 29, 32, seed=51)
    gout = np.random.default_rng(52).normal(size=(2, 29, 32)).astype(
        np.float32)
    ref = jax_grads(lambda *a: jax_bf16_gcl(attention, *a), d, GCL_KEYS,
                    gout)
    names = [k for k in GCL_KEYS if k != "adj"]
    for dtype in (BF16, "float32"):
        got = K.gcl_messages_backward_plain(
            torch.from_numpy(gout), *torch_args(d, GCL_KEYS, False),
            attention=attention, compute_dtype=dtype)
        got = [g for k, g in zip(GCL_KEYS, got) if k != "adj"]
        if dtype == BF16:
            assert_bf16_gate(got, ref, names)
        else:
            assert_fails_bf16_gate(got, ref, names)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("n_rows", [None, 13])
def test_vec_bf16_plain_backward_matches_jax_vjp(cross, tanh, n_rows):
    d = make_inputs(2, 29, 32, seed=53)
    gout = np.random.default_rng(54).normal(size=(2, 29, 3)).astype(
        np.float32)
    ref = jax_grads(lambda *a: jax_bf16_vec(cross, tanh, n_rows, *a), d,
                    VEC_KEYS, gout)
    names = [k for k in VEC_KEYS if k != "adj"]
    for dtype in (BF16, "float32"):
        got = K.edge_vector_reduce_backward_plain(
            torch.from_numpy(gout), *torch_args(d, VEC_KEYS, False),
            tanh=tanh, coords_range=15.0, norm_constant=1.0, cross=cross,
            norm_factor=100.0, n_rows=n_rows, compute_dtype=dtype)
        got = [g for k, g in zip(VEC_KEYS, got) if k != "adj"]
        if dtype == BF16:
            assert_bf16_gate(got, ref, names)
        else:
            assert_fails_bf16_gate(got, ref, names)


def test_pair_bf16_plain_backward_matches_jax_vjp():
    d, e = make_inputs(2, 29, 32, seed=55), make_inputs(2, 29, 32, seed=56)
    gout = np.random.default_rng(57).normal(size=(2, 29, 3)).astype(
        np.float32)
    keys = ("a0", "a1", "b0", "b1", "d2c", "d2i", "adj", "x", "center",
            "we0", "we1", "w20", "w21", "b20", "b21", "wout0", "wout1")
    both = {**{k: d[k] for k in ("d2c", "d2i", "adj", "x", "center")},
            **{f"{k}{s}": (d, e)[s][k] for k in SET_KEYS for s in (0, 1)}}

    def pair(a0, a1, b0, b1, d2c, d2i, adj, x, center, we0, we1, w20, w21,
             b20, b21, wout0, wout1):
        return (jax_bf16_vec(False, True, 19, a0, b0, d2c, d2i, adj, x,
                             center, we0, w20, b20, wout0)
                + jax_bf16_vec(True, True, 19, a1, b1, d2c, d2i, adj, x,
                               center, we1, w21, b21, wout1))

    ref = dict(zip([k for k in keys if k != "adj"],
                   jax_grads(pair, both, keys, gout)))
    t = {k: torch.from_numpy(v) for k, v in both.items()}
    args = [(t["a0"], t["a1"]), (t["b0"], t["b1"]), t["d2c"], t["d2i"],
            t["adj"], t["x"], t["center"], (t["we0"], t["we1"]),
            (t["w20"], t["w21"]), (t["b20"], t["b21"]),
            (t["wout0"], t["wout1"])]
    _, got, names = pair_flat(args, K.edge_vector_reduce_pair_backward_plain(
        torch.from_numpy(gout), *args, n_rows=19, compute_dtype=BF16))
    assert_bf16_gate(got, [ref[n] for n in names], names)


# -- (c) the Functions in bf16 ---------------------------------------------

@pytest.mark.parametrize("wanted", [("w2",), ("a", "d2c"), ("watt", "batt"),
                                    ("b", "we", "b2")])
def test_gcl_bf16_function_returns_none_where_not_asked(wanted):
    d = make_inputs(1, 7, 8, seed=61)
    args = [torch.from_numpy(d[k]).requires_grad_(k in wanted)
            for k in GCL_KEYS]
    K.reset_launches()
    with torch.enable_grad():
        out = K.gcl_messages(*args, compute_dtype=BF16)
    assert type(out.grad_fn).__name__ == "_GclMessagesBackward"
    grads = out.grad_fn.apply(torch.ones_like(out))
    assert len(grads) == 13
    for k, g in zip(GCL_KEYS, grads):
        assert (g is not None) == (k in wanted), k
    assert all(g is None for g in grads[10:])
    # the written-out bf16 backward, not the fp32 one
    ref = K.gcl_messages_backward_plain(
        torch.ones_like(out), *[a.detach() for a in args],
        compute_dtype=BF16)
    for k, g, r in zip(GCL_KEYS, grads, ref):
        if k in wanted:
            assert torch.equal(g, r), k
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("wanted", [("x", "center"), ("w2",),
                                    ("d2c", "wout")])
def test_vec_bf16_function_returns_none_where_not_asked(wanted):
    d = make_inputs(1, 7, 8, seed=62)
    args = [torch.from_numpy(d[k]).requires_grad_(k in wanted)
            for k in VEC_KEYS]
    K.reset_launches()
    with torch.enable_grad():
        out = K.edge_vector_reduce(*args, cross=True, compute_dtype=BF16)
    grads = out.grad_fn.apply(torch.ones_like(out))
    order = ("opts", "d2c", "d2i", "adj", "x", "center", *SET_KEYS)
    assert len(grads) == len(order)
    for k, g in zip(order, grads):
        assert (g is not None) == (k in wanted), k
    ref = K.edge_vector_reduce_backward_plain(
        torch.ones_like(out), *[a.detach() for a in args], cross=True,
        compute_dtype=BF16)
    by_name = dict(zip(VEC_KEYS, ref))
    for k, g in zip(order, grads):
        if k in wanted:
            assert torch.equal(g, by_name[k]), k
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


def test_bf16_pair_function_routes_through_the_bf16_plain_backward(
        monkeypatch):
    """In grad mode the bf16 pair goes through its Function, whose CPU
    backward is the plain backward in bf16, once per weight set."""
    seen = []
    fn = K.edge_vector_reduce_backward_plain
    monkeypatch.setattr(K, "edge_vector_reduce_backward_plain",
                        lambda *a, **k: (seen.append(a[-1]), fn(*a, **k))[1])
    d, e = make_inputs(1, 9, 8, seed=63), make_inputs(1, 9, 8, seed=64)
    two = {k: (torch.from_numpy(d[k]), torch.from_numpy(e[k]))
           for k in SET_KEYS}
    w2 = two["w2"][1].clone().requires_grad_()
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"), False)
    with torch.enable_grad():
        out = K.edge_vector_reduce_pair(
            two["a"], two["b"], *shared, two["we"], (two["w2"][0], w2),
            two["b2"], two["wout"], n_rows=5, compute_dtype=BF16)
    assert type(out.grad_fn).__name__ == "_EdgeVectorReduceBackward"
    out.sum().backward()
    assert seen == [BF16, BF16]
    assert torch.equal(K.bf16_round(w2.grad), w2.grad)
    assert float(w2.grad.abs().max()) > 0


# -- (d) the bf16 Trainer against JAX's -------------------------------------

T, NF = 50, 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0,
            compute_dtype=BF16)
TRAIN = dict(lr=1e-3, accumulate_grad_batches=2, clip_grad=True,
             auxiliary_loss=False, ema_decay=0.9, batch_size=4)
PLAIN_BACKWARDS = ("gcl_messages_backward_plain",
                   "edge_vector_reduce_backward_plain")


def to_torch(nb):
    return NodeBatch(*(torch.tensor(np.asarray(a)) for a in nb))


@pytest.fixture(scope="module")
def trainer_runs():
    """Two micro-steps (one update) on one batch, on both sides from the
    same weights, with the draws JAX made; the port in bf16 and in fp32,
    and which compute dtypes the port's plain backwards ran in."""
    lj = jparams["crossdock_full"]["lennard_jones_rm"]
    jc = jcore.CondDiffusion(jS.make_schedule("polynomial_2", T, 5e-4),
                             jcfg.DiffusionConfig(timesteps=T), NF, NF)
    tc = tcore.CondDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                             tcfg.DiffusionConfig(timesteps=T), NF, NF)
    # the port's seeded initialisation as JAX's tree (flax's own init
    # takes ~15 s here, eager or compiled)
    module = JaxDynamics(jcfg.EGNNConfig(**EGNN), atom_nf=NF, residue_nf=NF)
    torch.manual_seed(5)
    params = {}
    for path, value in params_to_jax(EGNNDynamics(
            tcfg.EGNNConfig(**EGNN), NF, NF).state_dict()).items():
        *parents, leaf = path.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    jt = JTrainer(jc, module, params, jcfg.TrainConfig(**TRAIN), lj_rm=lj,
                  mesh=make_mesh(1, devices=jax.devices()[:1]))
    ports = {}
    for dtype in (BF16, "float32"):
        dyn = EGNNDynamics(tcfg.EGNNConfig(**dict(EGNN, compute_dtype=dtype)),
                           NF, NF)
        dyn.load_state_dict(params_from_jax(params))
        ports[dtype] = Trainer(tc, dyn, tcfg.TrainConfig(**TRAIN), lj_rm=lj)
    ds = jdata.ProcessedLigandPocketDataset(DATA)
    lig, poc = next(iter(jdata.BucketedLoader(ds, 4, drop_feature_cols=1)))
    key = jax.random.PRNGKey(7)
    seen = []
    originals = {n: getattr(K, n) for n in PLAIN_BACKWARDS}

    def recording(fn):
        def call(*a, **kw):
            seen.append(kw.get("compute_dtype", a[-1]))
            return fn(*a, **kw)
        return call

    steps = []
    try:
        for n, fn in originals.items():
            setattr(K, n, recording(fn))
        for _ in range(2):
            key, k = jax.random.split(key)
            row = {"jax": jt.train_step(k, lig, poc)}
            k_t, k_noise, _ = jax.random.split(k, 3)
            t_int = torch.tensor(np.asarray(jax.random.randint(
                k_t, (4,), 0, T + 1)), dtype=torch.float32)
            noise = torch.tensor(np.asarray(jax.random.normal(
                k_noise, lig.xh.shape)))
            for dtype, tt in ports.items():
                mark = len(seen)
                row[dtype] = tt.train_step(to_torch(lig), to_torch(poc),
                                           t_int, noise)
                row[dtype + " backwards"] = seen[mark:]
            steps.append(row)
    finally:
        for n, fn in originals.items():
            setattr(K, n, fn)
    return ports, steps


def test_bf16_trainer_two_micro_steps_against_jax(trainer_runs):
    ports, steps = trainer_runs
    for row in steps:
        (jloss, jinfo), (loss, info) = row["jax"], row[BF16]
        assert abs(loss - jloss) <= TRAINER_RTOL * abs(jloss), (loss, jloss)
        assert abs(info["grad_norm"] - jinfo["grad_norm"]) <= \
            TRAINER_RTOL * jinfo["grad_norm"], (info, jinfo)
        # the bf16 config ran the bf16 backward of every call, and the
        # fp32 one the fp32 backward
        assert row[BF16 + " backwards"]
        assert set(row[BF16 + " backwards"]) == {BF16}
        assert set(row["float32 backwards"]) == {"float32"}
        assert loss != row["float32"][0]
    tt = ports[BF16]
    assert tt.step == 2 and tt.opt.count == 1
    assert all(bool(torch.isfinite(p).all()) for p in tt.params + tt.ema)
    assert all(p.dtype == torch.float32 for p in tt.params)
