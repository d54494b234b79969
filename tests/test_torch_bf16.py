"""The port's bf16 compute mode against the JAX package's on the CPU.

``EGNNConfig.compute_dtype = "bfloat16"`` reaches the JAX package's Pallas
kernels as ``mxu_dtype`` (run here in interpret mode) and its dense chain
through XLA.  Held here, on the same seeded inputs and weights:

- the plain bf16 ``gcl_messages``, ``edge_vector_reduce`` (difference and
  cross) and the pair against the Pallas kernels with ``mxu_dtype =
  bfloat16``.  Both round the same operands (z, W2, m, watt / wout) to
  bf16 and sum in fp32; what differs is silu (XLA's logistic against
  torch's: where an operand sits at a bf16 rounding midpoint, its last
  fp32 bit moves it by one bf16 ulp, 2^-8) and the order of the fp32
  sums.  Gate: max |port - JAX| <= 2e-4 max |JAX| (seen: 1e-6 of it for
  gcl_messages, 7.5e-5 for the vector kernel, one such flip).  The fp32
  plain version lies more than four times the gate away on the same
  inputs, which the tests check too, so they tell the two modes apart;
- ``EGNNDynamics`` with ``compute_dtype="bfloat16"`` against the JAX one
  with ``use_pallas=True, pallas_interpret=True``, compiled as the JAX
  package runs it: h, the coordinates, d2i, W_e and the aggregates are
  rounded outside the kernels on both sides.  XLA fuses the bf16 d2c: it
  rounds each coordinate difference and then squares and sums in fp32
  with one rounding, which ``models/egnn.current_d2`` does too.  Seen:
  1e-6 apart; tolerance rtol 1e-4, atol 1e-5, as the fp32 forwards';
- one dense-chain variant (``mean`` aggregation) in bf16 against the JAX
  package's compiled XLA path in bf16 (h, the edge features and adj
  rounded, the directions in bf16, the sums in fp32).  XLA fuses the bf16
  direction maths and keeps fp32 inside a fusion where torch rounds each
  operation; seen: 8e-5 apart, where fp32 lies 4e-3 away.  Tolerance rtol
  1e-3, atol 2e-4 (JAX's own bf16 kernel tests use rtol 2e-2, atol 2e-3);
- the CPU's bf16 path differentiates; the packing of W2 for the bf16
  kernel's ``wgmma`` (an index model of the swizzled layout) and a mirror
  of its rows per block against the shared-memory sums its source states.

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
from diffndm_tpu.ops import pallas_egnn as PK  # noqa: E402
from diffndm_tpu_torch import config as tcfg  # noqa: E402
from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402
from test_torch_dynamics import port_dynamics  # noqa: E402

KERNEL_GATE = 2e-4            # of max |JAX|
PALLAS_RTOL, PALLAS_ATOL = 1e-4, 1e-5
DENSE_RTOL, DENSE_ATOL = 1e-3, 2e-4
B, N, H = 2, 21, 32
GCL_KEYS = ("a", "b", "d2c", "d2i", "adj", "we", "w2", "b2", "watt", "batt")
VEC_KEYS = ("a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
            "wout")
SET_KEYS = ("a", "b", "we", "w2", "b2", "wout")
ATOM_NF = RESIDUE_NF = 10


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kernel_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, N, 3)) * 2).astype(np.float32)
    x0 = x + rng.normal(size=x.shape).astype(np.float32) * 0.5

    def f(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    d2c = ((x[:, :, None] - x[:, None]) ** 2).sum(-1).astype(np.float32)
    return dict(
        a=f(B, N, H, scale=0.5), b=f(B, N, H, scale=0.5), d2c=d2c,
        d2i=((x0[:, :, None] - x0[:, None]) ** 2).sum(-1).astype(np.float32),
        adj=(d2c < 16.0).astype(np.float32), we=f(2, H, scale=0.05),
        w2=f(H, H, scale=H ** -0.5), b2=f(H, scale=0.1),
        watt=f(H, 1, scale=H ** -0.5), batt=f(1, scale=0.1), x=x,
        center=x.mean(1, keepdims=True), wout=f(H, 1, scale=H ** -0.5))


def torch_args(d, keys):
    return [torch.from_numpy(d[k]) for k in keys]


def jax_args(d, keys):
    return [jnp.asarray(d[k]) for k in keys]


def close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.abs(got - want).max())


def kernel_close(got, want):
    err = np.abs(got - want).max()
    assert err <= KERNEL_GATE * np.abs(want).max(), err


def kernel_apart(fp32, want):
    """The fp32 version lies beyond four times the gate."""
    assert np.abs(fp32 - want).max() > 4 * KERNEL_GATE * np.abs(want).max()


@pytest.mark.parametrize("attention", [True, False])
def test_gcl_messages_bf16_matches_pallas(attention):
    d = kernel_inputs(0)
    want = np.asarray(PK.gcl_messages(
        *jax_args(d, GCL_KEYS), attention=attention, row_tile=8,
        col_tile=16, interpret=True, mxu_dtype=jnp.bfloat16))
    got = K.gcl_messages(*torch_args(d, GCL_KEYS), attention=attention,
                         compute_dtype="bfloat16").numpy()
    kernel_close(got, want)
    fp32 = K.gcl_messages(*torch_args(d, GCL_KEYS),
                          attention=attention).numpy()
    kernel_apart(fp32, want)


@pytest.mark.parametrize("cross", [False, True])
def test_edge_vector_reduce_bf16_matches_pallas(cross):
    d = kernel_inputs(1)
    want = np.asarray(PK.edge_vector_reduce(
        *jax_args(d, VEC_KEYS), tanh=True, coords_range=15.0, cross=cross,
        row_tile=8, col_tile=16, interpret=True, mxu_dtype=jnp.bfloat16))
    got = K.edge_vector_reduce(*torch_args(d, VEC_KEYS), cross=cross,
                               compute_dtype="bfloat16").numpy()
    kernel_close(got, want)
    fp32 = K.edge_vector_reduce(*torch_args(d, VEC_KEYS), cross=cross).numpy()
    kernel_apart(fp32, want)


def test_edge_vector_reduce_pair_bf16_matches_two_pallas_calls():
    """The pair: the difference direction with the first set plus the
    cross direction with the second, over one graph."""
    d, e = kernel_inputs(2), kernel_inputs(3)
    want = sum(np.asarray(PK.edge_vector_reduce(
        *jax_args({**d, **{k: s[k] for k in SET_KEYS}}, VEC_KEYS),
        cross=cross, row_tile=8, col_tile=16, interpret=True,
        mxu_dtype=jnp.bfloat16)) for s, cross in ((d, False), (e, True)))
    pairs = {k: (torch.from_numpy(d[k]), torch.from_numpy(e[k]))
             for k in SET_KEYS}
    shared = torch_args(d, ("d2c", "d2i", "adj", "x", "center"))
    args = [pairs["a"], pairs["b"], *shared, pairs["we"], pairs["w2"],
            pairs["b2"], pairs["wout"]]
    got = K.edge_vector_reduce_pair(*args, compute_dtype="bfloat16").numpy()
    kernel_close(got, want)


def test_bf16_plain_differentiates_on_the_cpu():
    """On the CPU a bf16 call in grad mode goes through the wrapper's
    autograd Function, whose backward is the plain bf16 backward (the
    written-out VJP of the bf16 forward; on the card the bf16 backward
    kernel); tests/test_torch_bf16_backward.py holds it to autograd and
    to JAX."""
    d = kernel_inputs(4)
    args = torch_args(d, GCL_KEYS)
    a = args[0].clone().requires_grad_(True)
    out = K.gcl_messages(a, *args[1:], compute_dtype="bfloat16")
    (grad,) = torch.autograd.grad(out.square().sum(), a)
    assert grad.shape == a.shape and torch.isfinite(grad).all()
    assert grad.abs().sum() > 0
    with torch.no_grad():
        again = K.gcl_messages(*args, compute_dtype="bfloat16")
    assert torch.equal(out.detach(), again)


def test_compute_dtype_is_checked():
    d = kernel_inputs(5)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.gcl_messages(*torch_args(d, GCL_KEYS), compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        tcfg.EGNNConfig(compute_dtype="float16")


def slot_of(r):
    """The A slot of k = r inside a k-step of 16: thread t computes k =
    4t..4t+3 and packs 4t, 4t+1 into slots 2t, 2t+1 and 4t+2, 4t+3 into
    2t+8, 2t+9."""
    t, j = divmod(r, 4)
    return 8 * (j // 2) + 2 * t + j % 2


def wgmma_offset(k, n, h):
    """Byte offset of bf16(W2[k, n]) in the bf16 kernel's shared copy of
    W2: slab k // 64 of h rows of 128 bytes, row n, 16-byte group g of the
    row (k-step q of the slab: groups 2q, 2q + 1) stored at g ^ (n % 8)."""
    slab, r = divmod(k, 64)
    q, s = divmod(slot_of(r % 16) + 16 * (r // 16), 16)
    group = 2 * q + s // 8
    return slab * h * 128 + n * 128 + 16 * (group ^ (n % 8)) + 2 * (s % 8)


@pytest.mark.parametrize("h", [64, 128])
def test_pack_w2_bf16_layout(h):
    """[H/64, H, 64] bf16 for wgmma's K-major B with the 128-byte swizzle:
    every bf16(W2[k, n]) where the index model puts it, each 16-byte group
    holding eight k of one column and one k-step half (whole under the
    swizzle), and the packing cached per weight tensor."""
    w2 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(h, h)).astype(np.float32))
    packed = K.pack_w2_bf16(w2)
    assert packed.shape == (h // 64, h, 64)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    flat = packed.reshape(-1)
    ref = w2.to(torch.bfloat16)
    where = {}
    for k in range(h):
        for n in range(h):
            off = wgmma_offset(k, n, h)
            assert torch.equal(flat[off // 2], ref[k, n])
            where[off // 2] = (k, n)
    assert len(where) == h * h                 # every element once
    for group in range(h * h // 8):
        ks, ns = zip(*(where[8 * group + i] for i in range(8)))
        assert len(set(ns)) == 1               # one column
        assert len({k // 16 for k in ks}) == 1     # one k-step
        assert len({slot_of(k % 16) // 8 for k in ks}) == 1   # one half
    first = K.pack_w2_bf16_cached(w2)
    assert K.pack_w2_bf16_cached(w2) is first
    w2.mul_(0.5)                               # bumps the version counter
    assert K.pack_w2_bf16_cached(w2) is not first
    assert torch.equal(K.pack_w2_bf16_cached(w2), K.pack_w2_bf16(w2))


# The bf16 kernel's rows per block (``pick_rows`` in csrc/egnn_edge.cu),
# mirrored: one block per SM or fewer, at most 16 rows, fewer where the
# shared memory would not hold them.  Bytes besides the edge list: 1024
# of alignment, W2 whole in bf16, its barrier, and the fp32 arrays (a rows,
# four weight vectors, gcl's row sums and heads, row starts).
SMEM_LIMIT, R_MAX, NW, SMS = 232448, 16, 8, 132


def bf16_fixed_bytes(h, vec):
    floats = R_MAX * h + 4 * h + (0 if vec else (R_MAX + NW) * h) \
        + R_MAX + 1 + NW + 3
    return 1024 + 2 * h * h + 16 + 4 * floats


def bf16_rows(bsz, rows, n, n_sets, h, vec):
    r = min(-(-bsz * rows * n_sets // SMS), R_MAX, rows)
    r = max(r, 1)
    while r > 1 and bf16_fixed_bytes(h, vec) + r * n * (16 if vec else 4) \
            > SMEM_LIMIT:
        r -= 1
    return r


@pytest.mark.parametrize("h,vec,fixed", [
    (128, False, 56448), (192, False, 108672), (256, False, 177280),
    (128, True, 44160), (192, True, 90240), (256, True, 152704)])
def test_bf16_shared_memory_sums(h, vec, fixed):
    """The fixed bytes that the source's note states for each width."""
    assert bf16_fixed_bytes(h, vec) == fixed


@pytest.mark.parametrize("shape,n_rows,n_sets,vec,rows,total", [
    # v3b's first forward: 80 rows of gcl_messages, the pair on 24 ligand
    # rows
    ((16, 80, 192), 80, 1, False, 10, 111872),
    ((16, 80, 192), 24, 2, True, 6, 97920),
    # the joint first forward: every row of both
    ((16, 584, 128), 584, 1, False, 16, 93824),
    ((16, 584, 128), 584, 2, True, 16, 193664),
    # the flagship: gcl_messages at 16 rows is the tightest fit
    ((20, 344, 256), 344, 1, False, 16, 199296),
    ((20, 344, 256), 24, 2, True, 8, 196736),
    # the largest N the wrappers take: three rows, or one of the pair
    ((1, 4096, 256), 4096, 1, False, 3, 226432),
    ((1, 4096, 256), 4096, 2, True, 1, 218240)])
def test_bf16_rows_per_block_mirror(shape, n_rows, n_sets, vec, rows,
                                    total):
    """The mirror's rows per block and the shared memory they take at the
    main path's shapes, within the card's 232,448 bytes; ``launch_grid``
    reports the library's choice on the card (scripts/forward_build_ab.py
    --bf16 prints it per case)."""
    bsz, n, h = shape
    r = bf16_rows(bsz, n_rows, n, n_sets, h, vec)
    used = bf16_fixed_bytes(h, vec) + r * n * (16 if vec else 4)
    assert (r, used) == (rows, total)
    assert used <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# the denoiser
# ---------------------------------------------------------------------------

def dynamics_inputs(seed, b=2, nl=8, npk=24):
    rng = np.random.default_rng(seed)
    lm = np.ones((b, nl), np.float32)
    lm[1, 6:] = 0
    pm = np.ones((b, npk), np.float32)
    pm[0, 20:] = 0
    xh_lig = rng.normal(size=(b, nl, 3 + ATOM_NF)).astype(np.float32) * \
        lm[..., None]
    xh_poc = (rng.normal(size=(b, npk, 3 + RESIDUE_NF)) * 2).astype(
        np.float32) * pm[..., None]
    t = np.array([0.2, 0.7], np.float32)
    return xh_lig, xh_poc, t, lm, pm


def compare_with_jax(jc, seed, rtol, atol):
    """The port's forward against JAX's on JAX's random init; returns the
    largest difference of each output and the port's fp32 forward."""
    inputs = dynamics_inputs(seed)
    module = JaxDynamics(jc, atom_nf=ATOM_NF, residue_nf=RESIDUE_NF)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)
    ref = jax.jit(module.apply)(params, *inputs)
    tc = tcfg.EGNNConfig(**{f.name: getattr(jc, f.name)
                            for f in dataclasses.fields(tcfg.EGNNConfig)})
    model = port_dynamics(tc, ATOM_NF, RESIDUE_NF, params)
    fp32 = port_dynamics(dataclasses.replace(tc, compute_dtype="float32"),
                         ATOM_NF, RESIDUE_NF, params)
    with torch.no_grad():
        args = [torch.from_numpy(np.asarray(v)) for v in inputs]
        out = [o.numpy() for o in model(*args)]
        out32 = [o.numpy() for o in fp32(*args)]
    return ([close(o, np.asarray(r), rtol, atol)
             for o, r in zip(out, ref)], out32, ref)


def small_config(**kw):
    return jcfg.EGNNConfig(hidden_nf=32, joint_nf=16, n_layers=2,
                           edge_cutoff_pocket=5.0,
                           edge_cutoff_interaction=5.0,
                           compute_dtype="bfloat16", **kw)


def test_dynamics_bf16_matches_jax_pallas_path():
    errs, out32, ref = compare_with_jax(small_config(
        use_pallas=True, pallas_interpret=True), 7, PALLAS_RTOL, PALLAS_ATOL)
    # the fp32 forward is told apart from the bf16 one
    assert np.abs(out32[0] - np.asarray(ref[0])).max() > 10 * max(errs)


def test_dense_chain_bf16_matches_jax_xla_path():
    """``mean`` aggregation runs the dense chain on both sides (the JAX
    package's XLA path, which rounds h, the edge features and adj and
    computes the directions in bf16)."""
    errs, out32, ref = compare_with_jax(small_config(
        aggregation_method="mean"), 8, DENSE_RTOL, DENSE_ATOL)
    assert np.abs(out32[0] - np.asarray(ref[0])).max() > 10 * max(errs)
