"""The arithmetic of the edge_vector_reduce backward kernel, emulated on the
CPU at v3b's width.

The kernel (csrc/egnn_edge_bwd.cu, edge_chain_bwd_vec) runs its three
products per edge on the TF32 tensor cores as a three-term split of both
operands, big*small + small*big + big*big, accumulated in fp32:

- u = s @ W2 and ds = du @ W2^T, over k-steps of 8 in the order the
  packed chunks give them;
- dW2 = s^T du, over k-steps of 8 edges, in 128-edge passes of each
  block's column-sorted edge list, a pass added to the block's record,
  then the records summed in record order by the second launch.

Here s and du come from the plain pair chain (the coordinate and cross
weight sets of v3b's first layer) on a seeded batch of two complexes of 88
nodes with 24 ligand rows; each product is emulated in that order with
``tf32_split`` parts and fp32 sums, and held to the gate chip_smoke.py
holds the backward kernels to (1e-4 x max|ref| + 1e-6 per tensor) against
float64.  One TF32 product without the split misses that gate, which is
why the kernel pays for three.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
LAYER = "params/egnn/e_block_0/gcl_equiv"
B, N, NL, H = 2, 88, 24, 192
PE, KSTEP, SMS = 128, 8, 132          # edges per pass, mma k, H100 SMs
GATE_RTOL, GATE_ATOL = 1e-4, 1e-6
SEED = 3


def _sq_dist(p):
    return ((p[:, :, None] - p[:, None, :]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def chain():
    """Per weight set (difference, cross): s and du of every edge (row <
    NL, adj != 0) in (batch, row, column) order, W2, and the edges."""
    rng = np.random.default_rng(SEED)
    f = np.float32
    lig = rng.normal(size=(B, NL, 3)) * 1.5
    poc = rng.normal(size=(B, N - NL, 3)) * 4.0
    x = np.concatenate([lig, poc], axis=1).astype(f)
    x0 = (x + rng.normal(size=x.shape) * 0.3).astype(f)
    d2c, d2i = _sq_dist(x).astype(f), _sq_dist(x0).astype(f)
    adj = ((d2c < 36.0) & ~np.eye(N, dtype=bool)).astype(f)
    h = rng.normal(size=(B, N, H)).astype(f)
    gout = (rng.normal(size=(B, N, 3)) * 1e-2).astype(f)
    t = torch.from_numpy
    x_t, d2c_t, d2i_t, adj_t, h_t, g_t = map(t, (x, d2c, d2i, adj, h, gout))
    center = x_t.mean(1, keepdim=True)
    mask = adj_t[:, :NL] != 0
    edges = mask.nonzero().tolist()
    out = []
    with np.load(NPZ) as w:
        for cross, name in ((False, "coord"), (True, "cross")):
            p = {k: t(w[f"{LAYER}/{name}_{k}"]) for k in (
                "src_kernel", "dst_kernel", "dst_bias", "edge_kernel",
                "l2_kernel", "l2_bias", "out_kernel")}
            a = h_t @ p["src_kernel"]
            b = h_t @ p["dst_kernel"] + p["dst_bias"]
            w2, wout = p["l2_kernel"], p["out_kernel"][:, 0]
            u1 = K._edge_pre(a[:, :NL], b, d2c_t[:, :NL], d2i_t[:, :NL],
                             p["edge_kernel"])
            s = F.silu(u1)
            u = s @ w2 + p["l2_bias"]
            th = torch.tanh(F.silu(u) @ wout)
            v, _ = K._direction(x_t[:, :NL, None, :], x_t[:, None, :, :],
                                center, cross, 1.0)
            dphi = adj_t[:, :NL] / 100.0 * (g_t[:, :NL, None, :] * v).sum(-1)
            dpr = dphi * 15.0 * (1.0 - th * th)
            du = dpr[..., None] * wout * K._dsilu(u)
            out.append(dict(s=s[mask].contiguous(), du=du[mask].contiguous(),
                            w2=w2.contiguous()))
    return out, edges


def kernel_ksteps():
    """The k order of the products by a packed matrix: chunk c of 16 rows,
    half h, thread t holds rows 16c + 4t + 2h and + 1."""
    return [[16 * c + 4 * t + 2 * h + j for t in range(4) for j in range(2)]
            for c in range(H // 16) for h in range(2)]


def three_term(a, b, steps):
    """Per k-step big*small + small*big + big*big, summed in fp32 in the
    mma's order (term after term, k-step after k-step): a [M, K], b [K,
    Nc], steps lists of K indices."""
    sa, sb = K.tf32_split(a), K.tf32_split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for ks in steps:
        ab, asm = sa[:, ks, 0], sa[:, ks, 1]
        bb, bs = sb[ks, :, 0], sb[ks, :, 1]
        acc = acc + ab @ bs
        acc = acc + asm @ bb
        acc = acc + ab @ bb
    return acc


def one_pass(a, b, steps):
    """One TF32 product per k-step, the same order and fp32 sums."""
    ra, rb = K.tf32_round(a), K.tf32_round(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for ks in steps:
        acc = acc + ra[:, ks] @ rb[ks, :]
    return acc


# rows per block: what the kernel picks for this batch on 132 SMs (one),
# and what it picks at the training shapes [16, 96, 192] (eight), where a
# block's list spans several passes
KERNEL_ROWS = -(-B * NL * 2 // SMS)
ROWS = [KERNEL_ROWS, 8]


def block_order(edges, rows):
    """The edge indices of each block's record, in record order: a block
    owns every G-th of the ligand rows of one batch element, its edges
    sorted by column and then row."""
    g = -(-NL // rows)
    records = []
    for bi in range(B):
        for x in range(g):
            mine = [(j, (i - x) // g, e) for e, (b_, i, j) in enumerate(edges)
                    if b_ == bi and i % g == x]
            records.append([e for _, _, e in sorted(mine)])
    return records


def dw2_in_kernel_order(s, du, records, product):
    """s^T du per 128-edge pass of each record, k-steps of 8 edges (the
    last one padded with zero rows), a pass added to its record, the
    records summed in order."""
    total = torch.zeros((H, H), dtype=torch.float32)
    for rec in records:
        part = torch.zeros((H, H), dtype=torch.float32)
        for p0 in range(0, len(rec), PE):
            idx = rec[p0:p0 + PE]
            pad = -len(idx) % KSTEP
            sp = torch.cat([s[idx], torch.zeros((pad, H))])
            dp = torch.cat([du[idx], torch.zeros((pad, H))])
            steps = [list(range(k, k + KSTEP))
                     for k in range(0, len(idx) + pad, KSTEP)]
            part = part + product(sp.T.contiguous(), dp, steps)
        total = total + part
    return total


def products(chain_set, records, product):
    s, du, w2 = chain_set["s"], chain_set["du"], chain_set["w2"]
    steps = kernel_ksteps()
    return {"s @ W2": (product(s, w2, steps), s.double() @ w2.double()),
            "du @ W2^T": (product(du, w2.T.contiguous(), steps),
                          du.double() @ w2.double().T),
            "s^T du": (dw2_in_kernel_order(s, du, records, product),
                       s.double().T @ du.double())}


def gate_share(got, ref):
    """max |got - ref| over the gate; <= 1 passes."""
    lim = GATE_RTOL * float(ref.abs().max()) + GATE_ATOL
    return float((got.double() - ref).abs().max()) / lim


@pytest.fixture(scope="module")
def shares(chain):
    """The gate share of every emulated product: (set, rows per block,
    "three") with the split, (set, "one") with one TF32 product."""
    sets, edges = chain
    out = {}
    # thousands of small products: one thread each, so that the test
    # workers running side by side do not oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _fill_shares(out, sets, edges)
    finally:
        torch.set_num_threads(threads)
    return out


def _fill_shares(out, sets, edges):
    for i in (0, 1):
        for rows in ROWS:
            out[i, rows, "three"] = {k: gate_share(*v) for k, v in products(
                sets[i], block_order(edges, rows), three_term).items()}
        out[i, "one"] = {k: gate_share(*v) for k, v in products(
            sets[i], block_order(edges, KERNEL_ROWS), one_pass).items()}


def test_the_batch_has_passes_of_every_kind(chain):
    """The seeded batch is a fair test: thousands of edges, records of one
    and of several 128-edge passes, and ragged last k-steps."""
    _, edges = chain
    assert KERNEL_ROWS == 1 and len(edges) > 1500
    for rows in ROWS:
        sizes = [len(r) for r in block_order(edges, rows)]
        assert sum(sizes) == len(edges) and any(n % KSTEP for n in sizes)
    assert max(len(r) for r in block_order(edges, 8)) > 2 * PE


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("which", ["s @ W2", "du @ W2^T", "s^T du"])
@pytest.mark.parametrize("set_index", [0, 1], ids=["difference", "cross"])
def test_three_term_products_hold_the_backward_gate(shares, set_index, which,
                                                     rows):
    assert shares[set_index, rows, "three"][which] <= 1.0


@pytest.mark.parametrize("set_index", [0, 1], ids=["difference", "cross"])
def test_single_pass_tf32_misses_the_gate(shares, set_index):
    """Why the split: one TF32 product per k-step, the same order and fp32
    sums, misses the gate on at least one of the three products, while the
    three-term split stays well inside it on all of them."""
    one = shares[set_index, "one"]
    three = shares[set_index, KERNEL_ROWS, "three"]
    assert max(one.values()) > 1.0, one
    assert max(three.values()) < 0.1, three
