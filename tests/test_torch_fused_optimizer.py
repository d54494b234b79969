"""The trainer's fused optimizer (``ops/fused_optimizer.py``) where no card
is needed: the leaf tables' plan, the CPU path and its counters, the
CUDA wrappers' tables and arguments run through a NumPy stand-in for the
library (each kernel's arithmetic on the tensors' memory, block by
block), and the optimizer seam the benchmark's fault tests patch.  The
kernels themselves are held against the plain path on the card by
``chip_smoke.py --only optimizer``.
"""

import ctypes

import numpy as np
import pytest
import torch

from diffndm_tpu_torch import config as tcfg
from diffndm_tpu_torch.data.dataset import (BucketedLoader,
                                            ProcessedLigandPocketDataset)
from diffndm_tpu_torch.diffusion import core as tcore
from diffndm_tpu_torch.diffusion import schedules as tS
from diffndm_tpu_torch.models.dynamics import EGNNDynamics
from diffndm_tpu_torch.ops import egnn_kernels as K
from diffndm_tpu_torch.ops import fused_optimizer as FO
from diffndm_tpu_torch.train.trainer import AmsgradState, Trainer

T, NF = 50, 10
DATA = "data/processed/virtual/val.npz"
EGNN = dict(hidden_nf=32, joint_nf=16, n_layers=2, attention=True,
            tanh=True, reflection_equivariant=False, edge_cutoff_ligand=None,
            edge_cutoff_pocket=5.0, edge_cutoff_interaction=5.0)
TRAIN = dict(lr=1e-3, accumulate_grad_batches=2, clip_grad=True,
             auxiliary_loss=False, ema_decay=0.9, batch_size=4)
# DiffSBDD's CrossDocked model's leaf sizes (configs/crossdock_fullatom_
# cond.yml, 176 leaves), by count
CROSSDOCK = sum(([n] * c for n, c in (
    (1, 6), (10, 2), (20, 4), (128, 2), (129, 1), (200, 4), (256, 67),
    (512, 18), (2560, 4), (33024, 2), (65536, 60), (131072, 6))), [])


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def block_span(launch, block, chunk):
    """(leaf within the launch, first element, elements) of a block, as the
    kernels' span_of finds it."""
    leaf = int(np.searchsorted(launch.chunk_end, block, side="right"))
    first = int(launch.chunk_end[leaf - 1]) if leaf else 0
    base = (block - first) * chunk
    return leaf, base, min(chunk, int(launch.numel[leaf]) - base)


def table_bytes(depth, capacity):
    """sizeof(LeafTable<depth, capacity>) in the source: the pointers, two
    int arrays and the count, padded to the pointers' alignment."""
    return -(-(8 * depth * capacity + 8 * capacity + 4) // 8) * 8


@pytest.mark.parametrize("numels, depth, chunk, capacity", [
    (CROSSDOCK, 6, FO.CHUNK, None),
    (CROSSDOCK, 2, FO.CHUNK, None),
    ((5, 0, 9, 0, 1, 17), 1, 4, 2),          # zero-size leaves
    ((40, 3, 0, 12, 1), 2, 8, 3),            # leaves larger than a chunk
    ((0, 0, 0), 1, 4, 2),                    # nothing to do
])
def test_plan_covers_every_leaf_once(numels, depth, chunk, capacity):
    launches = FO.plan(tuple(numels), depth, chunk, capacity)
    cap = FO.CAPACITY[depth] if capacity is None else capacity
    assert [lc.start for lc in launches] == list(range(0, len(numels), cap))
    assert launches[-1].stop == len(numels)
    first = 0
    covered = [np.zeros(n, dtype=int) for n in numels]
    for lc in launches:
        assert 0 < lc.stop - lc.start <= cap
        assert list(lc.numel) == list(numels[lc.start:lc.stop])
        assert lc.first_chunk == first
        assert lc.chunk_end.dtype == lc.numel.dtype == np.int32
        for b in range(lc.blocks):
            leaf, base, count = block_span(lc, b, chunk)
            assert 0 < count <= chunk
            covered[lc.start + leaf][base:base + count] += 1
        first += lc.blocks
    assert all((c == 1).all() for c in covered)
    assert first == sum(-(-n // chunk) for n in numels)


@pytest.mark.parametrize("depth", sorted(FO.CAPACITY))
def test_tables_fit_the_launch_parameter_space(depth):
    # the largest launch's other arguments: the amsgrad kernel's 10 floats
    # and a flag, the clip's pointers
    assert table_bytes(depth, FO.CAPACITY[depth]) + 64 <= FO.PARAM_BYTES
    assert 4 * FO.CLIP_CAPACITY + 8 + 64 <= FO.PARAM_BYTES


@pytest.mark.parametrize("numels, capacity", [
    (CROSSDOCK, FO.CLIP_CAPACITY), ((5, 0, 9, 0, 1, 17, 4), 3), ((), 4)])
def test_clip_ranges_follow_the_norm_pass(numels, capacity):
    numels = tuple(numels)
    ranges = FO.clip_plan(numels, 4, capacity)
    ends = np.concatenate([e for _, e in ranges])
    assert list(ends) == list(np.cumsum([-(-n // 4) for n in numels]))
    begins = [0] + [int(e[-1]) for _, e in ranges[:-1]]
    assert [b for b, _ in ranges] == begins
    assert all(len(e) <= capacity for _, e in ranges)


def test_crossdock_launches_per_micro_step():
    n = tuple(CROSSDOCK)
    count = lambda depth: len(FO.plan(n, depth))
    accumulating = count(1) + 1 + count(1) + count(2) + count(2)
    updating = count(1) + 1 + count(1) + count(6) + count(2)
    assert (accumulating, updating) == (7, 8)


def test_the_source_is_built_without_contraction():
    assert "-fmad=false" in FO.FLAGS
    fused = K.library_path(source=FO.SOURCE, flags=FO.FLAGS)
    assert fused != K.library_path(source=FO.SOURCE)
    assert fused.name.startswith("fused_optimizer-")
    text = FO.SOURCE.read_text()
    for name, value in (("THREADS", FO.THREADS), ("CHUNK", FO.CHUNK),
                        ("PARAM_BYTES", FO.PARAM_BYTES),
                        ("CAP1", FO.CAPACITY[1]), ("CAP2", FO.CAPACITY[2]),
                        ("CAP6", FO.CAPACITY[6]),
                        ("CAPF", FO.CLIP_CAPACITY)):
        assert f"constexpr int {name} = {value};" in text


# ---------------------------------------------------------------------------
# a NumPy stand-in for the library
# ---------------------------------------------------------------------------

f32 = np.float32


def _view(addr, n, ctype=ctypes.c_float):
    return np.ctypeslib.as_array((ctype * n).from_address(addr)) if n \
        else np.zeros(0, dtype=np.float32)


def _max_nan(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(a < b, b, a)))


def _min_nan(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(b < a, b, a)))


class FakeLibrary:
    """The C entries of ``csrc/fused_optimizer.cu`` over host memory: the
    table read as the entry fills it, each block's span found by the
    kernels' binary search, each kernel's arithmetic in fp32 NumPy ops in
    the source's order.  ``calls`` records the entries called."""

    def __init__(self):
        self.calls = []

    def _blocks(self, ptrs, stride, numel, chunk_end, n, depth):
        assert 0 < n <= FO.CAPACITY[depth]
        table = _view(ptrs, (depth - 1) * stride + n, ctypes.c_uint64)
        sizes = _view(numel, n, ctypes.c_int)
        ends = _view(chunk_end, n, ctypes.c_int)
        for c in range(int(ends[-1])):
            lo, hi = 0, n - 1
            while lo < hi:
                mid = (lo + hi) >> 1
                lo, hi = (lo, mid) if ends[mid] > c else (mid + 1, hi)
            base = (c - (int(ends[lo - 1]) if lo else 0)) * FO.CHUNK
            count = min(FO.CHUNK, int(sizes[lo]) - base)
            yield c, [_view(int(table[d * stride + lo]) + 4 * base, count)
                      for d in range(depth)]

    def fo_sum_squares(self, ptrs, stride, numel, chunk_end, n, partials,
                       stream):
        self.calls.append("fo_sum_squares")
        for c, (g,) in self._blocks(ptrs, stride, numel, chunk_end, n, 1):
            _view(partials, c + 1, ctypes.c_double)[c] = np.sum(
                (g * g).astype(np.float64))
        return 0

    def fo_clip(self, chunk_end, chunk_begin, n, partials, first, last,
                buf, buf_len, count, inv_count, slot, clip, stats, stream):
        self.calls.append("fo_clip")
        assert 0 <= n <= FO.CLIP_CAPACITY
        out, b = _view(stats, 4), _view(buf, buf_len)
        ends = _view(chunk_end, n, ctypes.c_int)
        total = int(ends[-1]) if n else chunk_begin
        part = _view(partials, total, ctypes.c_double)
        s = f32(0.0) if first else out[3]
        for j in range(n):
            lo = int(ends[j - 1]) if j else chunk_begin
            s = s + f32(np.sum(part[lo:int(ends[j])]))
        out[3] = s
        if not last:
            return 0
        gnorm = np.sqrt(f32(s))
        out[0] = gnorm
        if not clip:
            return 0
        valid = np.arange(buf_len) < count
        mean = f32(np.sum(np.where(valid, b, 0).astype(np.float64))) * \
            f32(inv_count)
        var = f32(np.sum(np.where(valid, (b - mean) * (b - mean), 0).astype(
            np.float64))) * f32(inv_count)
        thr = f32(1.5) * mean + f32(2.0) * np.sqrt(var)
        scale = _min_nan(thr / (gnorm + f32(1e-12)), f32(1.0))
        b[slot] = _min_nan(gnorm, thr)
        out[1], out[2] = thr, scale
        return 0

    def fo_scale(self, ptrs, stride, numel, chunk_end, n, stats, stream):
        self.calls.append("fo_scale")
        scale = _view(stats, 4)[2]
        for _, (g,) in self._blocks(ptrs, stride, numel, chunk_end, n, 1):
            g *= scale
        return 0

    def fo_accumulate(self, ptrs, stride, numel, chunk_end, n, inv_n,
                      stream):
        self.calls.append("fo_accumulate")
        for _, (g, a) in self._blocks(ptrs, stride, numel, chunk_end, n, 2):
            a[:] = a + (g - a) * f32(inv_n)
        return 0

    def fo_amsgrad(self, ptrs, stride, numel, chunk_end, n, inv_n, b1, omb1,
                   b2, omb2, inv_c1, inv_c2, eps, wd, neg_lr, decay, stream):
        self.calls.append("fo_amsgrad")
        k = [f32(x) for x in (inv_n, b1, omb1, b2, omb2, inv_c1, inv_c2,
                              eps, wd, neg_lr)]
        inv_n, b1, omb1, b2, omb2, inv_c1, inv_c2, eps, wd, neg_lr = k
        for _, (p, g, acc, mu, nu, vmax) in self._blocks(
                ptrs, stride, numel, chunk_end, n, 6):
            a = acc + (g - acc) * inv_n
            m = mu * b1 + omb1 * a
            v = nu * b2 + (omb2 * a) * a
            vm = _max_nan(vmax, v * inv_c2)
            u = (m * inv_c1) / (np.sqrt(vm) + eps)
            if decay:
                u = u + wd * p
            p[:] = p + neg_lr * u
            mu[:], nu[:], vmax[:], acc[:] = m, v, vm, 0.0
        return 0

    def fo_ema(self, ptrs, stride, numel, chunk_end, n, d, omd, copy,
               stream):
        self.calls.append("fo_ema")
        for _, (p, e) in self._blocks(ptrs, stride, numel, chunk_end, n, 2):
            e[:] = p if copy else e * f32(d) + f32(omd) * p
        return 0


@pytest.fixture
def fake(monkeypatch):
    """The CUDA wrappers on CPU tensors, through the stand-in."""
    lib = FakeLibrary()
    monkeypatch.setattr(FO, "_library", lambda: lib)

    def launch(name, device, entry, *args):
        assert entry(*args, None) == 0
        FO.LAUNCHES[name] += 1

    monkeypatch.setattr(FO, "_launch", launch)
    FO.reset_counts()
    return lib


def _leaves(rng, numels, scale=1.0):
    return [torch.from_numpy((rng.standard_normal(n) * scale).astype(
        np.float32)).reshape(-1) for n in numels]


def _ulps(a, b, peak=None):
    """The largest distance in ulps of the element's magnitude: the larger
    of |b| and ``peak``, the largest |b| held on the way (where a sum
    cancelled, an earlier rounding is judged at its operands' scale)."""
    mag = np.abs(b.numpy())
    if peak is not None:
        mag = np.maximum(mag, peak.numpy())
    diff = np.abs(a.numpy().astype(np.float64) - b.numpy())
    return float((diff / np.spacing(mag)).max()) if a.numel() else 0.0


SIZES = (7, 0, 5000, 300, 1, 9000, 12, 4096)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("gscale", [1e-3, 1e3])
def test_wrappers_through_the_stand_in_match_the_plain_path(fake, clip,
                                                            gscale):
    """clip_by_history's tables and arguments, run by the stand-in, give
    the plain version's norm, threshold, buffer and clipped gradients
    (within a few ulps: the plain path divides by count on the CPU where
    the kernel multiplies by its reciprocal, as PyTorch does on the
    card)."""
    rng = np.random.default_rng(3)
    grads = _leaves(rng, SIZES, gscale)
    buf = torch.tensor(rng.uniform(0.5, 20.0, 50).astype(np.float32))
    g_f, g_p = [g.clone() for g in grads], [g.clone() for g in grads]
    b_f, b_p = buf.clone(), buf.clone()
    n_f, t_f = FO._clip_cuda(g_f, b_f, 7, 7 % 50, clip)
    n_p, t_p = FO.clip_by_history_plain(g_p, b_p, 7, 7 % 50, clip)
    assert _ulps(n_f.reshape(1), n_p.reshape(1)) <= 2
    assert (t_f is None) == (t_p is None) == (not clip)
    if clip:
        assert _ulps(t_f.reshape(1), t_p.reshape(1)) <= 2
        assert (float(n_p) > float(t_p)) == (gscale > 1)
    assert _ulps(b_f, b_p) <= 2
    assert max(_ulps(a, b) for a, b in zip(g_f, g_p)) <= 4
    want = ["fo_sum_squares", "fo_clip"] + (["fo_scale"] if clip else [])
    assert fake.calls == want
    assert FO.LAUNCHES["optimizer_norm"] == 1


@pytest.mark.parametrize("decay", [0.0, 0.999])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-12])
def test_amsgrad_and_ema_through_the_stand_in_match_the_plain_path(
        fake, decay, weight_decay):
    """Four micro-steps at accumulate 2 (two updates) of amsgrad and the
    EMA through the wrappers' tables, over more leaves than one table
    holds, against the plain versions."""
    rng = np.random.default_rng(5)
    sizes = SIZES * 10            # 80 leaves: two amsgrad tables
    params = _leaves(rng, sizes)
    sides = {}
    for side in ("fused", "plain"):
        p = [t.clone() for t in params]
        state = [[torch.zeros_like(t) for t in params] for _ in range(4)]
        ema = [t.clone() for t in params]
        fn = (FO._amsgrad_cuda, FO._ema_cuda) if side == "fused" else \
            (FO.amsgrad_plain, FO.ema_plain)
        g_rng = np.random.default_rng(9)
        count = 0
        lists = (p, *state, ema)
        peak = [[t.abs() for t in ts] for ts in lists]
        for step in range(4):
            grads = _leaves(g_rng, sizes, 1e-2)
            n, update = step % 2 + 1, step % 2 == 1
            count += update
            fn[0](p, grads, *state, n, update, 1.0 - FO.B1 ** max(count, 1),
                  1.0 - FO.B2 ** max(count, 1), 1e-3, weight_decay)
            fn[1](ema, p, decay)
            peak = [[torch.maximum(m, t.abs()) for m, t in zip(ms, ts)]
                    for ms, ts in zip(peak, lists)]
        sides[side] = (lists, peak)
    for got, want, peak in zip(*sides["fused"][:1], *sides["plain"]):
        assert max(_ulps(a, b, m) for a, b, m in zip(got, want, peak)) <= 4
    moved = max(float((a - b).abs().max())
                for a, b in zip(sides["fused"][0][0], params) if b.numel())
    assert moved > 1e-4
    assert fake.calls.count("fo_amsgrad") == 2 * 2
    assert fake.calls.count("fo_accumulate") == 2
    assert FO.LAUNCHES["optimizer_ema"] == 4


def test_the_kernels_writes_move_the_version_counters(fake):
    """What the kernels write is marked as an in-place op marks it, so a
    cache keyed on a weight's version (the edge kernels' packed W2) sees
    the update."""
    rng = np.random.default_rng(4)
    params = _leaves(rng, SIZES)
    state = [[torch.zeros_like(t) for t in params] for _ in range(4)]
    grads = _leaves(rng, SIZES, 1e3)
    ema, buf = [t.clone() for t in params], torch.full((50,), 3.0)
    version = lambda ts: [t._version for t in ts]
    before = [version(ts) for ts in (params, *state, ema, grads, [buf])]
    FO._clip_cuda(grads, buf, 1, 0, True)
    FO._amsgrad_cuda(params, grads, *state, 1, True, 0.1, 0.001, 1e-3, 0.0)
    FO._ema_cuda(ema, params, 0.0)
    after = [version(ts) for ts in (params, *state, ema, grads, [buf])]
    for b, a in zip(before, after):
        assert all(y > x for x, y in zip(b, a))
    w2 = torch.zeros(128 * 128)
    square = w2.view(128, 128)
    packed = K.split_w2(square)
    assert K.split_w2(square) is packed
    FO._ema_cuda([w2], [torch.ones(128 * 128)], 0.0)
    assert K.split_w2(square) is not packed


def test_a_swapped_leaf_is_the_leaf_the_kernels_touch(fake):
    rng = np.random.default_rng(1)
    params = _leaves(rng, (300, 9000))
    ema = [t.clone() for t in params]
    FO._ema_cuda(ema, params, 0.0)
    params[1] = torch.full((9000,), 2.0)
    FO._ema_cuda(ema, params, 0.0)
    assert bool((ema[1] == 2.0).all())


@pytest.mark.parametrize("fault", ["dtype", "strided", "size", "count"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(fake, fault):
    rng = np.random.default_rng(2)
    params = _leaves(rng, (300, 64))
    ema = [t.clone() for t in params]
    if fault == "dtype":
        ema[1] = ema[1].double()
    elif fault == "strided":
        ema[1] = torch.zeros(128)[::2]
    elif fault == "size":
        ema[1] = torch.zeros(65)
    else:
        ema = ema[:1]
    with pytest.raises(ValueError):
        FO._ema_cuda(ema, params, 0.0)
    assert fake.calls == []


# ---------------------------------------------------------------------------
# the trainer on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batches():
    ds = ProcessedLigandPocketDataset(DATA)
    loader = BucketedLoader(ds, 4, drop_feature_cols=1)
    return [b for _, b in zip(range(2), loader)]


def _trainer():
    torch.manual_seed(0)
    tc = tcore.CondDiffusion(tS.make_schedule("polynomial_2", T, 5e-4),
                             tcfg.DiffusionConfig(timesteps=T), NF, NF)
    dyn = EGNNDynamics(tcfg.EGNNConfig(**EGNN), NF, NF)
    return Trainer(tc, dyn, tcfg.TrainConfig(**TRAIN),
                   generator=torch.Generator().manual_seed(1))


def _state(trainer):
    o = trainer.opt
    return [t.clone() for t in (*trainer.params, *o.mu, *o.nu, *o.nu_max,
                                *o.acc)]


def test_cpu_training_takes_the_plain_path(batches):
    trainer = _trainer()
    FO.reset_counts()
    for lig, poc in batches:
        loss, info = trainer.train_step(lig, poc)
        assert np.isfinite(loss) and {"grad_norm", "clip_threshold"} <= \
            set(info)
    assert FO.PLAIN_CALLS == {"clip": 2, "amsgrad": 2, "ema": 2}
    assert not any(FO.LAUNCHES.values())
    assert trainer.opt.count == 1 and trainer.gradnorm_count == 3


def test_a_frozen_update_leaves_params_and_state_unchanged(batches,
                                                           monkeypatch):
    """The seam the benchmark's fault tests patch: an update that returns
    False touches nothing, so params and the optimizer's moments stay as
    they were through train_step (the EMA follows the unchanged params;
    the clip's buffer still takes the norms)."""
    trainer = _trainer()
    before, norms = _state(trainer), trainer.gradnorm_buf.clone()
    monkeypatch.setattr(AmsgradState, "update",
                        lambda self, params, grads: False)
    for lig, poc in batches:
        trainer.train_step(lig, poc)
    for a, b in zip(_state(trainer), before):
        assert torch.equal(a, b)
    for e, p in zip(trainer.ema, trainer.params):
        torch.testing.assert_close(e, p, rtol=1e-6, atol=0.0)
    assert not torch.equal(trainer.gradnorm_buf, norms)
    assert trainer.step == 2 and trainer.opt.count == 0
