"""The arithmetic of the backward kernel of both edge-chain kernels,
emulated on the CPU at v3b's width.

The kernel (csrc/egnn_edge_bwd.cu, edge_chain_bwd_mma) runs its three
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

The gcl_messages epilogue the same way, with v3b's first-layer
gcl_messages weights (its attention gate and bias) on every edge of a
seeded batch: u = s @ W2 + b2 in the kernel's order, then in fp32 the
attention epilogue (gate, datt, dm, du), then du @ W2^T and s^T du in the
kernel's order and passes, with attention on and off, each result held to
the same gate against the chain in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

NPZ = "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz"
LAYER = "params/egnn/e_block_0/gcl_equiv"
GCL = "params/egnn/e_block_0/gcl_0"
B, N, NL, H = 2, 88, 24, 192
PE, KSTEP, SMS = 128, 8, 132          # edges per pass, mma k, H100 SMs
GATE_RTOL, GATE_ATOL = 1e-4, 1e-6
SEED = 3


def _sq_dist(p):
    return ((p[:, :, None] - p[:, None, :]) ** 2).sum(-1)


def _geometry(rng):
    """A ligand of NL atoms in a pocket: coordinates, the two squared
    distance planes and the 6 A adjacency, float32."""
    f = np.float32
    lig = rng.normal(size=(B, NL, 3)) * 1.5
    poc = rng.normal(size=(B, N - NL, 3)) * 4.0
    x = np.concatenate([lig, poc], axis=1).astype(f)
    x0 = (x + rng.normal(size=x.shape) * 0.3).astype(f)
    d2c, d2i = _sq_dist(x).astype(f), _sq_dist(x0).astype(f)
    adj = ((d2c < 36.0) & ~np.eye(N, dtype=bool)).astype(f)
    return x, d2c, d2i, adj


@pytest.fixture(scope="module")
def chain():
    """Per weight set (difference, cross): s and du of every edge (row <
    NL, adj != 0) in (batch, row, column) order, W2, and the edges."""
    rng = np.random.default_rng(SEED)
    f = np.float32
    x, d2c, d2i, adj = _geometry(rng)
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


def block_order(edges, rows, n_rows=NL):
    """The edge indices of each block's record, in record order: a block
    owns every G-th of the n_rows computed rows (the ligand's, for the
    vector kernel) of one batch element, its edges sorted by column and
    then row."""
    g = -(-n_rows // rows)
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


# ---------------------------------------------------------------------------
# the gcl_messages epilogue
# ---------------------------------------------------------------------------

# rows per block of the gcl backward: what the kernel picks for this batch
# on 132 SMs (two), and at the training shapes [16, 96, 192] (twelve)
GCL_ROWS = [-(-B * N // SMS), 12]
GCL_RESULTS = ("u", "du", "ds", "dW2", "dwatt", "dbatt")


def gcl_epilogue(u, g, av, watt, batt, attention):
    """What the kernel computes from u = s @ W2 + b2 of each edge, in u's
    dtype: du, and datt and m for the sums dwatt = sum datt * m and dbatt =
    sum datt.  g: the output gradient of the edge's row; av: adj / 100."""
    sg = torch.sigmoid(u)
    m = u * sg
    if attention:
        gate = torch.sigmoid(m @ watt + batt)
        datt = av * (g * m).sum(-1) * gate * (1.0 - gate)
        dm = (av * gate)[:, None] * g + datt[:, None] * watt
    else:
        datt = torch.zeros_like(av)
        dm = av[:, None] * g
    return dm * (sg * (1.0 + u * (1.0 - sg))), datt, m


def gcl_results(s, g, av, w, attention, records, product):
    """u, du, ds, dW2, dwatt and dbatt of the gcl backward's edges, the
    products by ``product`` in the kernel's order (float64 where it is
    None: plain products of float64 copies)."""
    if product is None:
        s, g, av = s.double(), g.double(), av.double()
        w = {k: v.double() for k, v in w.items()}
        u = s @ w["w2"] + w["b2"]
    else:
        u = product(s, w["w2"], kernel_ksteps()) + w["b2"]
    du, datt, m = gcl_epilogue(u, g, av, w["watt"], w["batt"], attention)
    if product is None:
        ds, dw2 = du @ w["w2"].T, s.T @ du
    else:
        ds = product(du, w["w2"].T.contiguous(), kernel_ksteps())
        dw2 = dw2_in_kernel_order(s, du, records, product)
    return dict(u=u, du=du, ds=ds, dW2=dw2,
                dwatt=(datt[:, None] * m).sum(0), dbatt=datt.sum())


@pytest.fixture(scope="module")
def gcl_chain():
    """s, the row's output gradient and adj / 100 of every edge (adj !=
    0, every row) of a seeded batch in (batch, row, column) order, v3b's
    first-layer gcl_messages weights, and the edges."""
    rng = np.random.default_rng(SEED + 1)
    f = np.float32
    _, d2c, d2i, adj = _geometry(rng)
    h = rng.normal(size=(B, N, H)).astype(f)
    gout = (rng.normal(size=(B, N, H)) * 1e-2).astype(f)
    t = torch.from_numpy
    d2c_t, d2i_t, adj_t, h_t, g_t = map(t, (d2c, d2i, adj, h, gout))
    with np.load(NPZ) as npz:
        p = {k: t(npz[f"{GCL}/{k}"]) for k in (
            "edge_src_kernel", "edge_dst_kernel", "edge_dst_bias",
            "edge_edge_kernel", "edge_l2_kernel", "edge_l2_bias",
            "att_kernel", "att_bias")}
    a = h_t @ p["edge_src_kernel"]
    b = h_t @ p["edge_dst_kernel"] + p["edge_dst_bias"]
    s = F.silu(K._edge_pre(a, b, d2c_t, d2i_t, p["edge_edge_kernel"]))
    mask = adj_t != 0
    w = dict(w2=p["edge_l2_kernel"].contiguous(), b2=p["edge_l2_bias"],
             watt=p["att_kernel"][:, 0], batt=p["att_bias"][0])
    return dict(s=s[mask].contiguous(),
                g=g_t[:, :, None, :].expand(B, N, N, H)[mask].contiguous(),
                av=adj_t[mask] / 100.0, w=w), mask.nonzero().tolist()


@pytest.fixture(scope="module")
def gcl_shares(gcl_chain):
    """The gate share of each result: (attention, rows per block) ->
    {result: share}."""
    ch, edges = gcl_chain
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for attention in (True, False):
            ref = gcl_results(ch["s"], ch["g"], ch["av"], ch["w"], attention,
                              None, None)
            for rows in GCL_ROWS:
                got = gcl_results(ch["s"], ch["g"], ch["av"], ch["w"],
                                  attention, block_order(edges, rows, N),
                                  three_term)
                out[attention, rows] = {k: gate_share(got[k], ref[k])
                                        for k in GCL_RESULTS}
    finally:
        torch.set_num_threads(threads)
    return out


def test_the_gcl_batch_has_passes_of_every_kind(gcl_chain):
    """Every row computed: thousands of edges, records of one and of
    several 128-edge passes, ragged last k-steps; the attention gate away
    from its ends, so that datt is not vanishingly small."""
    ch, edges = gcl_chain
    assert len(edges) > 4000
    for rows in GCL_ROWS:
        sizes = [len(r) for r in block_order(edges, rows, N)]
        assert sum(sizes) == len(edges) and any(n % KSTEP for n in sizes)
    assert min(len(r) for r in block_order(edges, GCL_ROWS[0], N)) <= PE
    assert max(len(r) for r in block_order(edges, 12, N)) > 2 * PE
    w = ch["w"]
    m = F.silu(ch["s"] @ w["w2"] + w["b2"])
    gate = torch.sigmoid(m @ w["watt"] + w["batt"])
    assert 0.05 < float(gate.median()) < 0.95


@pytest.mark.parametrize("result", GCL_RESULTS)
@pytest.mark.parametrize("rows", GCL_ROWS)
@pytest.mark.parametrize("attention", [True, False],
                         ids=["attention", "no-attention"])
def test_gcl_three_term_chain_holds_the_backward_gate(gcl_shares, attention,
                                                      rows, result):
    assert gcl_shares[attention, rows][result] <= 1.0
