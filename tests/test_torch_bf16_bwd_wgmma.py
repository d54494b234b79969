"""The bf16 backward kernel on wgmma (edge_chain_bwd_wgmma in
csrc/egnn_edge_bwd.cu), held on the CPU where its arithmetic and its
index maps can be: the card holds the kernel itself to the plain bf16
backward (``chip_smoke.py --only bf16train``).

- (a) Its products emulated in its order on v3b's first-layer weights, B
  = 2, N = 88 (24 ligand rows for the pair): s' and W2' exact in bf16; du,
  which the VJP keeps in fp32, split into DU_PARTS bf16 parts, each part's
  product exact and summed in fp32 per k-step of 16 (u = s' W2' and ds =
  du W2'^T) and per 16-edge step of each block's 64-edge passes (dW2 = s'^T
  du, a pass's sum added to the block's record, the records in order).
  The gradients are held to chip_smoke.py's bf16 gate (``bf16_bwd_gate``:
  BF16_BWD_L2 in relative L2 norm against the plain bf16 backward in
  float64, or twice the plain fp32's distance) and its rounding-point
  check for ds' (``rounding_share`` >= BF16_POINT_MIN).  On the products
  themselves three parts lie no further from float64 than the previous
  kernel's two-part TF32 split emulated the same way (k-steps of 8,
  128-edge passes), and two parts lie further: hence three.  One part
  would round du, a rounding point the VJP does not have, and misses the
  ds' check.
- (b) The shared-memory reads of the three products, on a byte model of
  the kernel's buffers: W2' as ``pack_w2_bf16`` lays it out, s' and du's
  parts as the kernel stores them, each read through wgmma's canonical
  128-byte-swizzled layouts (K-major: rows of 128 bytes, 8-row groups 1024
  bytes apart; MN-major: 64 of M or N per 128-byte row, rows the K index)
  with the addresses the kernel's descriptors give.  Every element of
  every product's operands is the one the product needs, in particular
  ds = du W2'^T reading the K-major copy of W2' transposed (MN-major, a
  slab's row n being 64 k in the A slots' order), whose accumulator
  columns land on the k of the silu'(u1) each thread kept, at H = 128,
  192 and 256.
- (c) ``bwd_rows_per_block``, the mirror of the kernel's rows per block,
  against the shared memory the kernel's header states.

Torch runs on one thread.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from diffndm_tpu_torch.ops import egnn_kernels as K  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz")
LAYER = "params/egnn/e_block_0/gcl_equiv"
GCL = "params/egnn/e_block_0/gcl_0"
B, N, NL, H = 2, 88, 24, 192
SEED = 3
PE, KSTEP = 64, 16                    # the kernel's pass and k-step
TF32_PE, TF32_KSTEP = 128, 8          # the previous kernel's
DU_PARTS = 3
SMS = 132


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_gates", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) the products in the kernel's order
# ---------------------------------------------------------------------------

def _sq_dist(p):
    return ((p[:, :, None] - p[:, None, :]) ** 2).sum(-1)


def _geometry(rng):
    f = np.float32
    lig = rng.normal(size=(B, NL, 3)) * 1.5
    poc = rng.normal(size=(B, N - NL, 3)) * 4.0
    x = np.concatenate([lig, poc], axis=1).astype(f)
    x0 = (x + rng.normal(size=x.shape) * 0.3).astype(f)
    d2c, d2i = _sq_dist(x).astype(f), _sq_dist(x0).astype(f)
    adj = ((d2c < 36.0) & ~np.eye(N, dtype=bool)).astype(f)
    return x, d2c, d2i, adj


def du_parts(du, n):
    """du as n bf16 parts, each the rounding of what the earlier ones
    leave (the kernel's split3)."""
    out, rest = [], du
    for _ in range(n):
        q = K.bf16_round(rest)
        out.append(q)
        rest = rest - q
    return out


def tf32_parts(du):
    """The previous kernel's split: du's TF32 remainder, then its TF32
    value, in the order it multiplied them."""
    big = K.tf32_round(du)
    return [K.tf32_round(du - big), big]


def rows_of(edges, rows, n_rows):
    """The edge indices of each block's record, in record order: a block
    owns every G-th of the n_rows computed rows of one batch element, its
    edges sorted by column and then row."""
    g = -(-n_rows // rows)
    records = []
    for bi in range(B):
        for x in range(g):
            mine = [(j, (i - x) // g, e) for e, (b_, i, j) in enumerate(edges)
                    if b_ == bi and i % g == x]
            records.append([e for _, _, e in sorted(mine)])
    return records


def kstep_sum(a, parts, kstep):
    """a [M, K] @ sum(parts) with every part's product per k-step of
    ``kstep`` added to an fp32 sum, part after part (parts [K, Nc])."""
    acc = torch.zeros((a.shape[0], parts[0].shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], kstep):
        for q in parts:
            acc = acc + a[:, k0:k0 + kstep] @ q[k0:k0 + kstep]
    return acc


def dw2_sum(s, parts, records, pe, kstep):
    """s^T du per pass of ``pe`` edges of each record, steps of ``kstep``
    edges, each part after the other; a pass's sum added to its record,
    the records summed in order."""
    h = s.shape[1]
    total = torch.zeros((h, h), dtype=torch.float32)
    for rec in records:
        record = torch.zeros((h, h), dtype=torch.float32)
        for p0 in range(0, len(rec), pe):
            idx = rec[p0:p0 + pe]
            acc = torch.zeros((h, h), dtype=torch.float32)
            for e0 in range(0, len(idx), kstep):
                st = idx[e0:e0 + kstep]
                for q in parts:
                    acc = acc + s[st].T @ q[st]
            record = record + acc
        total = total + record
    return total


def chain_products(s, du, w2r, records, parts, pe, kstep):
    """ds = du @ W2'^T and dW2 = s'^T du in the order of a kernel whose du
    parts ``parts`` gives."""
    q = parts(du)
    ds = torch.zeros_like(du)
    for k0 in range(0, du.shape[1], kstep):
        for part in q:
            ds = ds + part[:, k0:k0 + kstep] @ w2r.T[k0:k0 + kstep]
    return ds, dw2_sum(s, q, records, pe, kstep)


class Chain:
    """Per edge with adj != 0 among the rows computed: the forward
    recomputed in the kernel's arithmetic up to du, for one weight set."""

    def __init__(self, a, b, d2c, d2i, we, w2, b2, edges):
        self.idx = tuple(torch.tensor(c) for c in zip(*edges))
        bi, ii, jj = self.idx
        self.w2r = K.bf16_round(w2)
        self.dc, self.di = d2c[bi, ii, jj], d2i[bi, ii, jj]
        u1 = ((a[bi, ii] + b[bi, jj]) + self.dc[:, None] * we[0]) \
            + self.di[:, None] * we[1]
        sg = torch.sigmoid(u1)
        self.s = K.bf16_round(u1 * sg)
        self.dsl = sg * (1.0 + u1 * (1.0 - sg))
        u = kstep_sum(self.s, [self.w2r], KSTEP) + b2
        sgu = torch.sigmoid(u)
        self.m = u * sgu
        self.mr = K.bf16_round(self.m)
        self.dsu = sgu * (1.0 + u * (1.0 - sgu))
        self.we = we

    def finish(self, dm, records, parts, pe, kstep):
        """From dm: (da, db, dd2c, dd2i, dwe, dW2 rounded, db2), dd2c /
        dd2i [B, N, N]."""
        bi, ii, jj = self.idx
        du = dm * self.dsu
        ds, dw2 = chain_products(self.s, du, self.w2r, records, parts, pe,
                                 kstep)
        dz = K.bf16_round(ds) * self.dsl
        h = dz.shape[1]
        da = torch.zeros((B, N, h)).index_put_((bi, ii), dz, accumulate=True)
        db = torch.zeros((B, N, h)).index_put_((bi, jj), dz, accumulate=True)
        dd2c, dd2i = torch.zeros((B, N, N)), torch.zeros((B, N, N))
        dd2c[bi, ii, jj] = dz @ self.we[0]
        dd2i[bi, ii, jj] = dz @ self.we[1]
        dwe = torch.stack([(dz * self.dc[:, None]).sum(0),
                           (dz * self.di[:, None]).sum(0)])
        return da, db, dd2c, dd2i, dwe, K.bf16_round(dw2), du.sum(0)


@pytest.fixture(scope="module")
def gcl_case():
    """gcl_messages (attention) of v3b's first layer on every row."""
    rng = np.random.default_rng(SEED + 1)
    f = np.float32
    _, d2c, d2i, adj = _geometry(rng)
    h = rng.normal(size=(B, N, H)).astype(f)
    gout = (rng.normal(size=(B, N, H)) * 1e-2).astype(f)
    t = torch.from_numpy
    d2c, d2i, adj, h, gout = map(t, (d2c, d2i, adj, h, gout))
    with np.load(NPZ) as npz:
        p = {k: t(npz[f"{GCL}/{k}"]) for k in (
            "edge_src_kernel", "edge_dst_kernel", "edge_dst_bias",
            "edge_edge_kernel", "edge_l2_kernel", "edge_l2_bias",
            "att_kernel", "att_bias")}
    args = [h @ p["edge_src_kernel"],
            h @ p["edge_dst_kernel"] + p["edge_dst_bias"], d2c, d2i, adj,
            p["edge_edge_kernel"], p["edge_l2_kernel"], p["edge_l2_bias"],
            p["att_kernel"], p["att_bias"]]
    return dict(args=args, gout=gout,
                edges=(adj != 0).nonzero().tolist(), names=[
                    "a", "b", "d2c", "d2i", "we", "w2", "b2", "watt",
                    "batt"])


def gcl_emulated(case, rows, parts=None, pe=PE, kstep=KSTEP):
    a, b, d2c, d2i, adj, we, w2, b2, watt, batt = case["args"]
    parts = parts or (lambda v: du_parts(v, DU_PARTS))
    edges = case["edges"]
    ch = Chain(a, b, d2c, d2i, we, w2, b2, edges)
    bi, ii, jj = ch.idx
    wattr = K.bf16_round(watt)[:, 0]
    g = case["gout"][bi, ii]
    av = adj[bi, ii, jj] / 100.0
    gate = torch.sigmoid(ch.mr @ wattr + batt)
    datt = av * (ch.m * g).sum(-1) * gate * (1.0 - gate)
    dm = (av * gate)[:, None] * g + K.bf16_round(datt[:, None] * wattr)
    out = ch.finish(dm, rows_of(edges, rows, N), parts, pe, kstep)
    return [*out, K.bf16_round((datt[:, None] * ch.mr).sum(0))[:, None],
            datt.sum()[None]]


def gcl_reference(case, dtype):
    cast = [x.to(dtype) for x in case["args"]]
    g = K.gcl_messages_backward_plain(case["gout"].to(dtype), *cast, True,
                                      100.0, "bfloat16")
    return [x for i, x in enumerate(g) if i != 4]


@pytest.fixture(scope="module")
def pair_case():
    """The pair (v3b's first-layer difference and cross weight sets) on
    the 24 ligand rows."""
    rng = np.random.default_rng(SEED)
    f = np.float32
    x, d2c, d2i, adj = _geometry(rng)
    h = rng.normal(size=(B, N, H)).astype(f)
    gout = (rng.normal(size=(B, N, 3)) * 1e-2).astype(f)
    t = torch.from_numpy
    x, d2c, d2i, adj, h, gout = map(t, (x, d2c, d2i, adj, h, gout))
    sets = []
    with np.load(NPZ) as npz:
        for name in ("coord", "cross"):
            p = {k: t(npz[f"{LAYER}/{name}_{k}"]) for k in (
                "src_kernel", "dst_kernel", "dst_bias", "edge_kernel",
                "l2_kernel", "l2_bias", "out_kernel")}
            sets.append((h @ p["src_kernel"],
                         h @ p["dst_kernel"] + p["dst_bias"],
                         p["edge_kernel"], p["l2_kernel"], p["l2_bias"],
                         p["out_kernel"]))
    mask = torch.zeros_like(adj, dtype=torch.bool)
    mask[:, :NL] = adj[:, :NL] != 0
    return dict(sets=sets, d2c=d2c, d2i=d2i, adj=adj, x=x,
                center=x.mean(1, keepdim=True), gout=gout,
                edges=mask.nonzero().tolist())


PAIR_NAMES = ["a0", "a1", "b0", "b1", "d2c", "d2i", "we0", "we1", "w20",
              "w21", "b20", "b21", "wout0", "wout1"]


def pair_emulated(case, rows, parts=None, pe=PE, kstep=KSTEP):
    """The chain's gradients of the pair (not dx and dcenter, which no
    product touches), in PAIR_NAMES' order."""
    parts = parts or (lambda v: du_parts(v, DU_PARTS))
    edges = case["edges"]
    per = []
    for s, (a, b, we, w2, b2, wout) in enumerate(case["sets"]):
        ch = Chain(a, b, case["d2c"], case["d2i"], we, w2, b2, edges)
        bi, ii, jj = ch.idx
        woutr = K.bf16_round(wout)[:, 0]
        dot = ch.mr @ woutr
        th = torch.tanh(dot)
        x = case["x"]
        v, _ = K._direction(x[bi, ii][:, None, None, :],
                            x[bi, jj][:, None, None, :],
                            case["center"][bi], bool(s), 1.0)
        av = case["adj"][bi, ii, jj] / 100.0
        dphi = av * (case["gout"][bi, ii] * v[:, 0, 0]).sum(-1)
        coef = dphi * 15.0 * (1.0 - th * th)
        dm = K.bf16_round(coef[:, None] * woutr)
        out = ch.finish(dm, rows_of(edges, rows, NL), parts, pe, kstep)
        per.append([*out, K.bf16_round((coef[:, None] * ch.mr).sum(0))[:,
                                                                        None]])
    (da0, db0, c0, i0, we0, w0, bb0, o0), (da1, db1, c1, i1, we1, w1, bb1,
                                           o1) = per
    return [da0, da1, db0, db1, c0 + c1, i0 + i1, we0, we1, w0, w1, bb0,
            bb1, o0, o1]


def pair_reference(case, dtype):
    sets = [[t.to(dtype) for t in st] for st in case["sets"]]
    g = K.edge_vector_reduce_pair_backward_plain(
        case["gout"].to(dtype), *[tuple(st[i] for st in sets)
                                  for i in (0, 1)],
        case["d2c"].to(dtype), case["d2i"].to(dtype), case["adj"].to(dtype),
        case["x"].to(dtype), case["center"].to(dtype),
        *[tuple(st[i] for st in sets) for i in (2, 3, 4, 5)],
        True, 15.0, 1.0, 100.0, NL, "bfloat16")
    a, b, d2c, d2i, _, _, _, we, w2, b2, wout = g
    return [*a, *b, d2c, d2i, *we, *w2, *b2, *wout]


def kernel_rows(n_rows, n_sets, vec):
    """The kernel's rows per block at this batch, and at the training
    shapes [16, 96, 192]: a block's list then spans several passes."""
    return [K.bwd_rows_per_block(B, N, H, n_rows, n_sets, vec),
            K.bwd_rows_per_block(16, 96, H, 96 if not vec else 24, n_sets,
                                 vec)]


CASES = {"gcl": (gcl_emulated, gcl_reference, N, 1, False),
         "pair": (pair_emulated, pair_reference, NL, 2, True)}


@pytest.fixture(scope="module")
def verdicts(gcl_case, pair_case):
    """Per case and rows per block: the emulated kernel's share of the
    bf16 gate, whether it passes, and its ds' rounding-point share; and
    the same for one part of du."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for label, case in (("gcl", gcl_case), ("pair", pair_case)):
            emulate, reference, n_rows, n_sets, vec = CASES[label]
            names = case.get("names", PAIR_NAMES)
            ref64 = reference(case, torch.float64)
            ref = [g.float() for g in ref64]
            sound = reference(case, torch.float32)
            with CS.dropped_rounding(K, "ds"):
                fault = reference(case, torch.float64)
            for rows in kernel_rows(n_rows, n_sets, vec):
                got = emulate(case, rows)
                share, ok = CS.bf16_bwd_gate(torch, K, got, ref, names,
                                             sound)
                out[label, rows] = dict(
                    share=share, ok=ok,
                    ds=CS.rounding_share(got, ref64, fault, names))
            one = emulate(case, kernel_rows(n_rows, n_sets, vec)[0],
                          parts=lambda v: du_parts(v, 1))
            out[label, "one part"] = dict(
                ds=CS.rounding_share(one, ref64, fault, names))
    finally:
        torch.set_num_threads(threads)
    return out


def test_the_batches_have_passes_of_every_kind(gcl_case, pair_case):
    """Thousands of edges; records of one and of several 64-edge passes;
    ragged last passes and 16-edge steps."""
    for label, case in (("gcl", gcl_case), ("pair", pair_case)):
        _, _, n_rows, n_sets, vec = CASES[label]
        assert len(case["edges"]) > 1500
        for rows in kernel_rows(n_rows, n_sets, vec):
            sizes = [len(r) for r in rows_of(case["edges"], rows, n_rows)]
            assert sum(sizes) == len(case["edges"])
            assert any(n % KSTEP for n in sizes)
        big = max(len(r) for r in rows_of(
            case["edges"], kernel_rows(n_rows, n_sets, vec)[1], n_rows))
        assert big > 2 * PE


@pytest.mark.parametrize("which", [0, 1], ids=["this-batch", "training"])
@pytest.mark.parametrize("label", ["gcl", "pair"])
def test_three_parts_hold_the_bf16_gate(verdicts, label, which):
    """The emulated kernel within chip_smoke.py's bf16 gate, nearer the
    float64 reference with the ds' rounding point than without it."""
    _, _, n_rows, n_sets, vec = CASES[label]
    v = verdicts[label, kernel_rows(n_rows, n_sets, vec)[which]]
    assert v["ok"], v
    assert v["ds"] >= CS.BF16_POINT_MIN, v


@pytest.mark.parametrize("label", ["gcl", "pair"])
def test_one_part_misses_the_rounding_point_check(verdicts, label):
    """One bf16 part would round du, which the VJP does not: the ds'
    rounding-point check sees it."""
    assert verdicts[label, "one part"]["ds"] < CS.BF16_POINT_MIN


@pytest.fixture(scope="module")
def product_errors(gcl_case):
    """Relative L2 distance to float64 of ds = du @ W2'^T and dW2 = s'^T
    du over gcl's edges, under a seeded du, per split: the kernel's with
    2 and 3 bf16 parts (k-steps of 16, 64-edge passes), and the previous
    kernel's TF32 split (k-steps of 8, 128-edge passes)."""
    a, b, d2c, d2i, _, we, w2, b2, _, _ = gcl_case["args"]
    edges = gcl_case["edges"]
    ch = Chain(a, b, d2c, d2i, we, w2, b2, edges)
    du = torch.randn(ch.s.shape, generator=torch.Generator().manual_seed(
        SEED)) * 1e-3
    ref_ds = du.double() @ ch.w2r.double().T
    ref_dw = ch.s.double().T @ du.double()
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for label, parts, pe, kstep in (
                ("tf32", tf32_parts, TF32_PE, TF32_KSTEP),
                (2, lambda v: du_parts(v, 2), PE, KSTEP),
                (3, lambda v: du_parts(v, 3), PE, KSTEP)):
            records = rows_of(edges, kernel_rows(N, 1, False)[1], N)
            ds, dw = chain_products(ch.s, du, ch.w2r, records, parts, pe,
                                    kstep)
            out[label] = (float((ds.double() - ref_ds).norm()
                                / ref_ds.norm()),
                          float((dw.double() - ref_dw).norm()
                                / ref_dw.norm()))
    finally:
        torch.set_num_threads(threads)
    return out


def test_three_parts_lie_no_further_than_the_tf32_split(product_errors):
    """Both products with du in three bf16 parts lie no further from
    float64 than with the earlier kernel's two TF32 parts; with two bf16
    parts (~16 bits of du) they lie over ten times further."""
    three, two, tf32 = (product_errors[k] for k in (3, 2, "tf32"))
    assert DU_PARTS == 3
    assert three[0] <= tf32[0] and three[1] <= tf32[1], product_errors
    assert two[0] > 10 * tf32[0] and two[1] > 10 * tf32[1], product_errors


# ---------------------------------------------------------------------------
# (b) the shared-memory reads of the three products
# ---------------------------------------------------------------------------

def swizzle(addr):
    """The 128-byte swizzle: 16-byte group bits 4-6 ^= row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def k_major(start, rows, kk):
    """Byte address of (row, k) of a K-major 16-bit tile: rows of 128
    bytes, 8-row groups 1024 bytes apart, 16 k of a step contiguous."""
    return swizzle(start + (rows // 8) * 1024 + (rows % 8) * 128 + kk * 2)


def mn_major(start, mn, kk, lbo):
    """Byte address of (m or n, k) of an MN-major 16-bit tile: 64 of M or
    N per 128-byte row, rows the k, 8-row groups 1024 bytes apart, 64-wide
    blocks lbo apart."""
    return swizzle(start + (mn // 64) * lbo + (kk // 8) * 1024
                   + (kk % 8) * 128 + (mn % 64) * 2)


def slot_k(s):
    return 4 * (s % 8 // 2) + 2 * (s // 8) + s % 2


def own_kstep(h, w, i):
    """The kernel's own_kstep: warpgroup w's k-step i."""
    if h == 128:
        return 4 * w + i
    if h == 192:
        return 8 * w + i if i < 4 else 2 * w + i
    return (i // 4) * 8 + w * 4 + i % 4


def pieces(h, w):
    """(slab, k offset, width, first tile) of warpgroup w's ds' in (6),
    as product6 runs them."""
    if h == 128:
        return [(w, 0, 64, 0)]
    if h == 192:
        return [(2 * w, 0, 64, 0), (1, 32 * w, 32, 8)]
    return [(w, 0, 64, 0), (w + 2, 0, 64, 8)]


def store_pass_operand(values, g_of_row):
    """A [64, H] bf16 pass operand as the kernel stores it: slab c / 64,
    row e, the 16-byte group of position p at (p / 8) ^ (e % 8); values
    given per (e, position).  Returns a flat element array."""
    e_n, h = values.shape
    out = np.zeros(h // 64 * 64 * 64, dtype=values.dtype)
    e = np.arange(e_n)[:, None]
    p = np.arange(h)[None, :]
    addr = (p // 64) * 128 * 64 + e * 128 + (((p % 64) // 8) ^ (e % 8)) * 16 \
        + (p % 8) * 2
    out[addr // 2] = values
    return out


@pytest.mark.parametrize("h", [128, 192, 256])
def test_shared_memory_reads(h):
    """Each product's operands, read through the descriptors' layouts,
    are the elements it multiplies."""
    rng = np.random.default_rng(h)
    w2 = torch.from_numpy(rng.normal(size=(h, h)).astype(np.float32))
    w2r = K.bf16_round(w2).numpy()
    packed = K.pack_w2_bf16(w2).float().numpy().reshape(-1)
    slab = 128 * h
    nk = h // 16
    # s' of the pass [64 edges, H k], stored by the threads that computed
    # it: position 16c + slot of k-step c holds k = 16c + slot_k(slot)
    s = rng.normal(size=(PE, h)).astype(np.float32)
    pos_k = np.array([16 * (p // 16) + slot_k(p % 16) for p in range(h)])
    s_store = store_pass_operand(s[:, pos_k], None)
    du = rng.normal(size=(PE, h)).astype(np.float32)
    du_store = store_pass_operand(du, None)
    kk = np.arange(16)
    # (3): warpgroup w, k-step c: A[e, kk] and B[kk, n] both hold k =
    # 16c + slot_k(kk)
    for w in (0, 1):
        for c in range(nk):
            e = np.arange(PE)[:, None]
            a = s_store[k_major((c // 4) * 128 * PE + (c % 4) * 32, e,
                                kk[None, :]) // 2]
            assert np.array_equal(a, s[:, 16 * c + np.array(
                [slot_k(x) for x in kk])])
            n = np.arange(h // 2)[:, None]
            addr = k_major(w * (h // 2) * 128 + (c // 4) * slab
                           + (c % 4) * 32, n, kk[None, :])
            want = w2r[16 * c + np.array([slot_k(x) for x in kk])][
                :, w * (h // 2) + np.arange(h // 2)].T
            assert np.array_equal(packed[addr // 2], want)
    # (5): tile (mb, nb), 16-edge step ks: A = s'^T (M = position m of
    # slab mb, MN-major), B = du (N = n, MN-major); the record's row of
    # accumulator row m = 16 wq + g (+8) is 64 mb + 16 wq + slot_k(...)
    for mb in range(h // 64):
        for ks in range(PE // 16):
            m = np.arange(64)[:, None]
            a = s_store[mn_major(mb * 128 * PE + ks * 2048, m, kk[None, :],
                                 128 * PE) // 2]
            k_row = np.array([64 * mb + 16 * (r // 16) + slot_k(r % 16)
                              for r in range(64)])
            assert np.array_equal(a, s[16 * ks + kk][:, k_row].T)
            wq, g = np.arange(64) // 16, np.arange(64) % 16
            kernel_row = 64 * mb + 16 * wq + np.array(
                [slot_k(x) for x in g])
            assert np.array_equal(kernel_row, k_row)
        for nb in range(h // 64):
            n = np.arange(64)[None, :]
            b = du_store[mn_major(nb * 128 * PE + ks * 2048, n,
                                  kk[:, None], 128 * PE) // 2]
            assert np.array_equal(b, du[16 * ks + kk][:, 64 * nb + n[0]])
    # (6): warpgroup w's pieces, K' step c' (n = 16c' + kk): A = du
    # (K-major) and B = W2' transposed (MN-major from the K-major copy);
    # accumulator column j of tile T is k = 16 own_kstep(T / 2) + 4t +
    # 2 (T % 2) + e (j = 2t + e), the k of the thread's silu'(u1)
    for w in (0, 1):
        covered = []
        for sl, off, width, tile in pieces(h, w):
            for c in range(nk):
                e = np.arange(PE)[:, None]
                a = du_store[k_major((c // 4) * 128 * PE + (c % 4) * 32, e,
                                     kk[None, :]) // 2]
                assert np.array_equal(a, du[:, 16 * c + kk])
                j = np.arange(width)[None, :]
                b = packed[mn_major(sl * slab + c * 16 * 128 + off * 2, j,
                                    kk[:, None], slab) // 2]
                tiles = tile + j[0] // 8
                col = j[0] % 8
                k = np.array([16 * own_kstep(h, w, int(T) // 2) for T in
                              tiles]) + 4 * (col // 2) + 2 * (tiles % 2) \
                    + col % 2
                assert np.array_equal(b, w2r[k][:, 16 * c + kk].T)
                if c == 0:
                    covered += list(k)
        # the warpgroup's columns are its own k-steps, each once
        own = sorted(16 * own_kstep(h, w, i) + x for i in range(h // 32)
                     for x in range(16))
        assert sorted(covered) == own


# ---------------------------------------------------------------------------
# (c) the rows per block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,vec,fixed", [
    (128, False, 169744), (192, False, 178960), (256, False, 204560),
    (128, True, 172048), (192, True, 181264), (256, True, 206864)])
def test_bf16_backward_shared_memory_sums(h, vec, fixed):
    """The fixed bytes that the kernel's header states for each width."""
    assert K.bwd_bf16_smem_bytes(h, vec, 0, 0) == fixed


@pytest.mark.parametrize("shape,n_rows,n_sets,vec,rows", [
    # a training forward at [16, 88, 192]: gcl on every row, the pair on
    # the ligand's (about one block per SM)
    ((16, 88, 192), 88, 1, False, 11),
    ((16, 88, 192), 24, 2, True, 6),
    ((16, 96, 192), 96, 1, False, 12),
    # [joint-train]: every row of both
    ((8, 416, 128), 416, 1, False, 16),
    ((8, 416, 128), 416, 2, True, 16),
    # the flagship: shared memory holds fewer than the 16 wanted
    ((20, 344, 256), 344, 1, False, 6),
    ((20, 344, 256), 24, 2, True, 7),
    # the largest N the wrappers take: one row
    ((1, 4096, 256), 4096, 1, False, 1),
    ((1, 4096, 256), 4096, 2, True, 1)])
def test_bf16_backward_rows_per_block(shape, n_rows, n_sets, vec, rows):
    """One block per SM or fewer, at most 16 rows, fewer where the shared
    memory would not hold them, within the card's 232,448 bytes."""
    bsz, n, h = shape
    r = K.bwd_rows_per_block(bsz, n, h, n_rows, n_sets, vec)
    assert r == rows
    if r:
        assert K.bwd_bf16_smem_bytes(h, vec, r, n) <= 232448
        if r < min(16, n_rows, -(-bsz * n_rows * n_sets // SMS)):
            assert K.bwd_bf16_smem_bytes(h, vec, r + 1, n) > 232448
