#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any fault or mismatch:

1. identity: the card (nvidia-smi name and power limit) and the builds,
   side by side, of the CUDA kernels from diffndm_tpu_torch/csrc (nvcc)
   and of the native reward scorer (host g++);
2. kernels: each EGNN edge-chain kernel against its plain PyTorch version
   on the card, on the inputs the main path gives it (captured from one
   denoiser forward), at the flagship shapes of
   configs/crossdock_fullatom_cond.yml (B=20, N=344, H=256, 5 A cutoff)
   and over a sweep of small ragged shapes and options; kernel time,
   plain time and the card's bound for the same work; every kernel output
   is computed twice and must come out bit-identical;
3. path check: a 10-step fixed-noise trajectory through the kernels on
   the card against the plain path on the CPU;
4. main path: 2 test pockets x 16 samples at T=500 from the committed
   v3b EMA weights, molecules built and written as SDF, with the kernel
   launch counts of that run;
5. guided: the same 2 pockets x 16 samples at T=500 with SPSA + ATP
   guidance at its defaults, every reward from the native scorer; the
   launch counts that follow from the config; seconds per pocket batch,
   the oracle's share of the wall time; and a 12-step fixed-noise guided
   trajectory on the card against the plain path on the CPU;
6. fan-out and oracle: the kernels against their plain versions on the
   inputs of one fused SPSA forward captured from the guided run
   ([k*2B, N, H] = [320, 80, 192]); the native scorer against the Python
   scorer on one 320-molecule population of that run;
7. quality: 8 test pockets x 16 samples, unguided and guided, scored by
   the evaluation protocol of the JAX package's guided-lift script
   (largest fragment, sizes floored at 4) beside that script's committed
   rows, with floors on validity, QED, SA and the guided lift;
8. step: a 50-step stretch of the unguided sampler with CUDA events
   around every kernel wrapper call and a profiler trace: ms per step,
   kernel ms per step inside the loop, the device's idle share.

``--only kernels`` stops after phase 2 and ``--only phases`` prints, from
a build of the kernels with cycle counters, where a block's time goes
(both for work on the kernels).  ``--only quality`` runs phase 7 alone
over five seeds and prints how far each metric moves with the random
stream (what a change to the kernels' arithmetic has to exceed).  None of
the three prints a result line.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(REPO, "examples", "checkpoints", "virtual_cond_v3b")
WEIGHTS = os.path.join(REPO, "diffndm_tpu_torch", "assets",
                       "virtual_cond_v3b_ema.npz")
DATA = os.path.join(REPO, "data", "processed", "virtual_v3")
POCKETS = (220, 48)          # the 40- and 36-atom test pockets
N_SAMPLES, T_MAIN, T_CHECK, T_STEP = 16, 500, 10, 50
SEED = 0
# quality phase: the protocol and the committed rows of the JAX package's
# scripts/guided_lift_eval.py (a TPU run of the JAX package; quality, not
# speed): examples/checkpoints/virtual_cond_v3b/guided_lift_tpu.json
N_QUALITY_POCKETS, MIN_LIGAND_ATOMS = 8, 4
JAX_ROWS = {
    "unguided": dict(valid=0.906, connectivity=0.868, connected=0.508,
                     qed=0.460, sa=0.486),
    "guided": dict(valid=1.0, connectivity=0.710, connected=0.055,
                   qed=0.565, sa=0.730)}
# floors: those of the JAX package's tests/test_guided_lift.py, lowered by
# about three standard errors at n = 128 (another random stream)
QUALITY_FLOORS = {"unguided": dict(valid=0.85, qed=0.42),
                  "guided": dict(valid=0.93, qed=0.52, sa=0.66)}
LIFT_FLOORS = dict(qed=0.05, sa=0.10)
QUALITY_SPREAD_SEEDS = 5     # --only quality
# guided path check: T, and windows scaled so that every event fires
T_GUIDED_CHECK = 12
GUIDED_CHECK = dict(spsa=dict(num_probes=2, start_step=6, every=2, zeta0=5.0),
                    atp=dict(num_groups=4, start_step=10, every=5))

# published H100 SXM peaks (dense TF32 on the tensor cores, HBM3).  The
# kernels split each product into three TF32 products; the bound counts
# the product once.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# kernel vs plain on the card: fp32 against a three-term TF32 split with
# fp32 accumulation, sums in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# path check: ten steps of fp32 forwards on two devices
PATH_COORD_ATOL = 1e-3       # Angstrom

KERNELS = {
    "gcl_messages": "diffndm_tpu/ops/pallas_egnn.py:151",
    "edge_vector_reduce": "diffndm_tpu/ops/pallas_egnn.py:269",
}
# wrapper -> the kernel it launches (the pair launches the vector kernel
# once for both weight sets)
WRAPPERS = {"gcl_messages": "gcl_messages",
            "edge_vector_reduce": "edge_vector_reduce",
            "edge_vector_reduce_pair": "edge_vector_reduce"}
SOURCE = "diffndm_tpu_torch/csrc/egnn_edge.cu"
# [B, N, H] of the edge-shape sweep; the last is large enough for blocks
# of several rows with a ragged last block
SWEEP_SHAPES = ((1, 7, 128), (3, 37, 192), (2, 50, 256), (24, 37, 128))


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# work and bound of one kernel call
# ---------------------------------------------------------------------------

def call_cost(name, args, kw):
    """(operations, bytes) that the call's data needs: the matrix
    products and per-edge dot products of the edges with a nonzero
    adjacency among the rows computed, once per weight set; each input
    read once, the output written once."""
    pair = name == "edge_vector_reduce_pair"
    a, adj = (args[0][0] if pair else args[0]), args[4]
    bsz, n, h = a.shape
    n_sets = 2 if pair else 1
    rows = kw.get("n_rows")
    rows = n if rows is None else max(0, min(n, rows))
    edges = int((adj[:, :rows] != 0).sum())
    per_edge = 2 * h * h + 2 * h + (2 * h if name == "gcl_messages" else 30)
    node = n_sets * (bsz * rows * h + bsz * n * h)
    planes = 3 * bsz * rows * n
    weights = n_sets * (h * h + 5 * h)
    if name == "gcl_messages":
        out = bsz * n * h
        extra = 0
    else:
        out = bsz * n * 3
        extra = bsz * n * 3 + bsz * 3
    return (n_sets * edges * per_edge,
            4 * (node + planes + weights + extra + out))


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(torch, fn, reps, warmup=3, rounds=5):
    """Device time of one call: CUDA events around ``reps`` calls queued
    behind a long matrix product, so that the host has enqueued them all
    before the first may start and its own cost per call stays out of the
    number.  Median over ``rounds``."""
    if not hasattr(time_ms, "blocker"):
        time_ms.blocker = torch.ones((8192, 8192), device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.mm(time_ms.blocker, time_ms.blocker)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def host_us(torch, fn, reps=200):
    """Host time of one call while the device queue has room."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def compare(torch, name, out, ref):
    """(max abs error, largest share of its tolerance that an element
    uses); raises where an element is beyond atol + rtol * |ref|."""
    err = (out - ref).abs()
    share = float((err / (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max())
    max_abs = float(err.max())
    if not bool(torch.isfinite(out).all()) or not share <= 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs "
            f"{max_abs:.3e}, {share:.2f} of atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}")
    return max_abs, share


def check_kernel(torch, K, name, args, kw, reps):
    kernel = getattr(K, name)
    plain = getattr(K, name + "_plain")
    out = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ in their bits")
    ref = plain(*args, **kw)
    max_abs, share = compare(torch, name, out, ref)
    ms = time_ms(torch, lambda: kernel(*args, **kw), reps)
    plain_ms = time_ms(torch, lambda: plain(*args, **kw), max(3, reps // 10),
                       warmup=1, rounds=3)
    b_ms, b_by = bound_ms(*call_cost(name, args, kw))
    shape = list((args[0][0] if name.endswith("_pair") else args[0]).shape)
    blocks, per_block = K.launch_grid(name, *shape, kw.get("n_rows"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(max_abs_err=max_abs, tolerance_share=share, ms=ms,
                host_us=host_us(torch, lambda: kernel(*args, **kw)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=shape, blocks=blocks, rows_per_block=per_block,
                blocks_per_sm=blocks / n_sm)


def check_calls(torch, K, wrapper, calls, reps):
    """Every captured call of ``wrapper`` against its plain version; the
    first one also timed.  The result carries the worst error of all."""
    errs = []
    for _, args, kw in calls:
        out = getattr(K, wrapper)(*args, **kw)
        torch.cuda.synchronize()
        errs.append(compare(torch, wrapper, out,
                            getattr(K, wrapper + "_plain")(*args, **kw)))
    _, args, kw = calls[0]
    res = check_kernel(torch, K, wrapper, args, kw, reps)
    res["max_abs_err"] = max(e[0] for e in errs)
    res["tolerance_share"] = max(e[1] for e in errs)
    return res


def describe(res):
    return (f"max abs {res['max_abs_err']:.3e}, at most "
            f"{res['tolerance_share']:.2f} of the tolerance; kernel "
            f"{res['ms']:.4f} ms (host {res['host_us']:.1f} us per call), "
            f"plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, TF32 {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
            f"or {PEAK_BYTES / 1e12:.2f} TB/s); grid {res['blocks']} blocks "
            f"of {res['rows_per_block']} rows, "
            f"{res['blocks_per_sm']:.2f} per SM")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def capture_kernel_calls(torch, K, model, pocket, sizes):
    """The kernel calls of one denoiser forward on the main path's first
    state (t = 1): the wrappers' arguments, recorded as given."""
    calls = []
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    from diffndm_tpu_torch.diffusion.core import init_ligand_from_pocket

    core = model.core
    nx, nh = core.cfg.norm_values
    lig_mask = model.sampler.ligand_mask(sizes, model.device)
    p_x = pocket.x / nx * pocket.mask[..., None]
    p_h = (pocket.h - core.cfg.norm_biases[1]) / nh * pocket.mask[..., None]
    g = torch.Generator(device=model.device).manual_seed(SEED)
    z, xh_p = init_ligand_from_pocket(core, p_x, p_h, lig_mask, pocket.mask,
                                      generator=g)
    t = torch.ones(z.shape[0], device=model.device)
    for n in WRAPPERS:
        setattr(K, n, recorder(n))
    try:
        with torch.no_grad():
            model.dynamics(z, xh_p, t, lig_mask, pocket.mask)
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    return calls


def flagship_inputs(torch, name, device):
    """Seeded inputs at the flagship shapes: 24 ligand atoms inside a
    320-atom pocket at protein density, 5 A cutoffs (ligand-ligand
    complete), hidden 256."""
    rng = np.random.default_rng(SEED)
    bsz, nl, npk, h = 20, 24, 320, 256
    radius = (3 * npk / (4 * np.pi * 0.05)) ** (1 / 3)
    pts = rng.normal(size=(bsz, npk, 3))
    pts *= (radius * rng.uniform(size=(bsz, npk, 1)) ** (1 / 3)
            / np.linalg.norm(pts, axis=-1, keepdims=True))
    lig = rng.normal(size=(bsz, nl, 3)) * 1.5
    x = np.concatenate([lig, pts], 1).astype(np.float32)
    x0 = (x + rng.normal(size=x.shape) * 0.5).astype(np.float32)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    is_lig = np.arange(nl + npk) < nl
    ll = is_lig[:, None] & is_lig[None, :]
    adj = (ll | (d2 <= 25.0)).astype(np.float32)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device)

    n = nl + npk
    f32 = np.float32
    common = [t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(bsz, n, h)) * 0.5), t(d2),
              t(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1)), t(adj)]
    we = t(rng.normal(size=(2, h)) * 0.05)
    w2 = t(rng.normal(size=(h, h)) / np.sqrt(h))
    b2 = t(rng.normal(size=(h,)) * 0.1)
    wvec = t(rng.normal(size=(h, 1)) / np.sqrt(h))
    if name == "gcl_messages":
        return common + [we, w2, b2, wvec, t(np.array([0.1], f32))], {}
    center = x.mean(1, keepdims=True)
    if name == "edge_vector_reduce":
        return (common + [t(x), t(center), we, w2, b2, wvec],
                dict(cross=True, n_rows=nl))
    second = [t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(2, h)) * 0.05),
              t(rng.normal(size=(h, h)) / np.sqrt(h)),
              t(rng.normal(size=(h,)) * 0.1),
              t(rng.normal(size=(h, 1)) / np.sqrt(h))]
    pairs = [(first, other) for first, other in
             zip(common[:2] + [we, w2, b2, wvec], second)]
    return ([pairs[0], pairs[1]] + common[2:] + [t(x), t(center)]
            + pairs[2:], dict(n_rows=nl))


def sweep_inputs(torch, device, bsz, n, h, seed):
    """Small ragged inputs: a random ~15 % adjacency with values in
    {0, 0.5, 1}, all-zero rows and (where B > 1) an all-zero batch
    element."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, n, 3)) * 2
    x0 = x + rng.normal(size=x.shape) * 0.5
    adj = (rng.uniform(size=(bsz, n, n)) < 0.15) * rng.choice(
        [0.5, 1.0], size=(bsz, n, n))
    adj[:, rng.choice(n, size=max(1, n // 5), replace=False)] = 0.0
    if bsz > 1:
        adj[bsz - 1] = 0.0

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device)

    def weight_set():
        return dict(a=t(rng.normal(size=(bsz, n, h)) * 0.5),
                    b=t(rng.normal(size=(bsz, n, h)) * 0.5),
                    we=t(rng.normal(size=(2, h)) * 0.05),
                    w2=t(rng.normal(size=(h, h)) / np.sqrt(h)),
                    b2=t(rng.normal(size=(h,)) * 0.1),
                    wvec=t(rng.normal(size=(h, 1)) / np.sqrt(h)))

    planes = [t(((x[:, :, None] - x[:, None]) ** 2).sum(-1)),
              t(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1)), t(adj)]
    return dict(sets=[weight_set(), weight_set()], planes=planes, x=t(x),
                center=t(x.mean(1, keepdims=True)),
                batt=t(np.array([0.1])))


def edge_shape_sweep(torch, K, device):
    """Each wrapper against its plain version where compaction and ragged
    tiles can break: odd sizes, empty rows, n_rows in {0, 5, N}, every
    option on and off."""
    n_cases, worst = 0, 0.0
    for seed, (bsz, n, h) in enumerate(SWEEP_SHAPES):
        d = sweep_inputs(torch, device, bsz, n, h, SEED + 10 + seed)
        s0, s1 = d["sets"]
        keys = ("we", "w2", "b2", "wvec")
        cases = [("gcl_messages",
                  [s0["a"], s0["b"], *d["planes"], *(s0[k] for k in keys),
                   d["batt"]], dict(attention=att)) for att in (True, False)]
        for n_rows in (0, 5, n):
            for tanh in (True, False):
                cases += [("edge_vector_reduce",
                           [s0["a"], s0["b"], *d["planes"], d["x"],
                            d["center"], *(s0[k] for k in keys)],
                           dict(tanh=tanh, cross=cross, n_rows=n_rows))
                          for cross in (False, True)]
                cases.append(("edge_vector_reduce_pair",
                              [(s0["a"], s1["a"]), (s0["b"], s1["b"]),
                               *d["planes"], d["x"], d["center"],
                               *((s0[k], s1[k]) for k in keys)],
                              dict(tanh=tanh, n_rows=n_rows)))
        for name, args, kw in cases:
            out = getattr(K, name)(*args, **kw)
            again = getattr(K, name)(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {kw} [{bsz}, {n}, {h}]: two "
                                     f"launches differ in their bits")
            ref = getattr(K, name + "_plain")(*args, **kw)
            worst = max(worst, compare(
                torch, f"{name} {kw} [{bsz}, {n}, {h}]", out, ref)[0])
            n_cases += 1
    log(f"[kernels] edge-shape sweep: {n_cases} cases at "
        f"{[list(s) for s in SWEEP_SHAPES]} within atol {KERNEL_ATOL} + rtol "
        f"{KERNEL_RTOL} of the plain versions, max abs {worst:.3e}, "
        f"repeat launches bit-identical")


def kernel_phase(torch, K, model, pocket, sizes):
    calls = capture_kernel_calls(torch, K, model, pocket, sizes)
    counts = {n: sum(1 for c in calls if c[0] == n) for n in WRAPPERS}
    log(f"[kernels] captured one forward's calls: {counts}")
    results = {}
    for wrapper, kernel in WRAPPERS.items():
        mine = [c for c in calls if c[0] == wrapper]
        if not mine:
            continue
        _, args, kw = mine[0]
        res = check_calls(torch, K, wrapper, mine, reps=50)
        res["entry"] = wrapper
        results[kernel] = res
        log(f"[kernels] main path {wrapper} {res['shape']} ({len(mine)} "
            f"calls checked, atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}): "
            f"{describe(res)}")
        if wrapper == "edge_vector_reduce_pair":
            # one weight set alone, the launch an earlier design made twice
            single = [args[0][0], args[1][0], *args[2:7],
                      *(w[0] for w in args[7:])]
            alone = check_kernel(torch, K, "edge_vector_reduce", single,
                                 dict(kw, cross=False), reps=50)
            log(f"[kernels] main path edge_vector_reduce, first set alone: "
                f"{describe(alone)}")
        if wrapper == "gcl_messages":
            # what a launch costs when no edge is there to compute
            empty = list(args)
            empty[4] = torch.zeros_like(args[4])
            empty_ms = time_ms(torch,
                               lambda: K.gcl_messages(*empty, **kw), 50)
            log(f"[kernels] main path gcl_messages with an all-zero "
                f"adjacency (launch, compaction and the write of zeros): "
                f"{empty_ms:.4f} ms")
    missing = set(KERNELS) - set(results)
    if missing:
        raise AssertionError(f"the forward launched no {sorted(missing)}")
    for name in WRAPPERS:
        args, kw = flagship_inputs(torch, name, model.device)
        res = check_kernel(torch, K, name, args, kw, reps=10)
        log(f"[kernels] flagship {name} {res['shape']} {kw}: "
            f"{describe(res)}")
    edge_shape_sweep(torch, K, model.device)
    return results


def phase_cycles(torch, K, model, pocket, sizes):
    """Where a block's cycles go, per kernel call of the main path and of
    the flagship shapes (the build with -DEGNN_PROFILE; thread 0 of each
    block counts, so a phase's figure is what warp 0 saw)."""
    K.PROFILE_BUILD = True
    calls = capture_kernel_calls(torch, K, model, pocket, sizes)
    cases = []
    for name in ("gcl_messages", "edge_vector_reduce_pair"):
        _, args, kw = next(c for c in calls if c[0] == name)
        cases.append(("main path", name, args, kw))
        cases.append(("flagship", name,
                      *flagship_inputs(torch, name, model.device)))
    for label, name, args, kw in cases:
        getattr(K, name)(*args, **kw)
        K.read_profile()                        # warm, and clear
        getattr(K, name)(*args, **kw)
        c = K.read_profile()
        blocks, passes = max(c["blocks"], 1), max(c["passes"], 1)
        rest = c["loop"] - c["wait"] - c["request"] - c["mma"]
        log(f"[phases] {label} {name}: {c['blocks']} blocks, "
            f"{c['passes']} passes of 128 edges; cycles per block: set-up "
            f"and compaction {c['setup'] / blocks:.0f}, chunk loop "
            f"{c['loop'] / blocks:.0f}; per pass: waiting for chunks "
            f"{c['wait'] / passes:.0f}, asking for them "
            f"{c['request'] / passes:.0f}, z and mma {c['mma'] / passes:.0f}, "
            f"epilogue {rest / passes:.0f}")
    K.PROFILE_BUILD = False


def fixed_noise(torch, model, sizes, steps):
    from diffndm_tpu_torch.diffusion.sampler import SamplerNoise
    from diffndm_tpu_torch.structs import pad_to

    rng = np.random.default_rng(SEED + 1)
    nl = pad_to(int(max(sizes)), model.sample_cfg.lig_pad_multiple)
    shape = (len(sizes), nl, 3 + model.cfg.atom_nf)

    def normal(*lead):
        return torch.from_numpy(rng.standard_normal(lead + shape)
                                .astype(np.float32))
    return SamplerNoise(normal(), normal(steps), normal())


def path_check(torch, make_model, pair):
    """The same fixed-noise trajectory on the card (kernels) and on the
    CPU (plain versions)."""
    sizes = np.array([12, 18, 9, 24])
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model(device)
        pocket = model.pocket_from_dataset(pair, len(sizes))
        noise = fixed_noise(torch, model, sizes, T_CHECK)
        res = model.sample_given_pocket(pocket, sizes, timesteps=T_CHECK,
                                        noise=noise)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask)]
    (xg, hg, mg), (xc, hc, mc) = out["cuda"], out["cpu"]
    err = float((xg - xc).abs().max())
    m = mc > 0.5
    same_types = bool(torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    log(f"[path] T={T_CHECK} fixed noise, B={len(sizes)}: max |x_cuda - "
        f"x_cpu| = {err:.3e} A (atol {PATH_COORD_ATOL}); atom types "
        f"identical: {same_types}")
    if not (err <= PATH_COORD_ATOL and same_types
            and bool(torch.isfinite(xg).all())):
        raise AssertionError("the kernel path disagrees with the plain path")


def main_path(torch, K, model, pockets, sizes):
    from diffndm_tpu_torch.chem.io import write_sdf

    K.reset_launches()
    mols, seconds, finite = [], [], True
    for pocket, n_lig in zip(pockets, sizes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = torch.Generator(device=model.device).manual_seed(SEED)
        res = model.sample_given_pocket(pocket, n_lig, timesteps=T_MAIN,
                                        generator=g)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        finite &= all(bool(torch.isfinite(v).all()) for v in
                      (res.ligand.x, res.ligand.h, res.pocket.x))
        expect = (N_SAMPLES, -(-int(max(n_lig)) // 8) * 8, 3)
        if tuple(res.ligand.x.shape) != expect:
            raise AssertionError(f"ligand shape {tuple(res.ligand.x.shape)}"
                                 f" != {expect}")
        mols += model.result_to_molecules(res)
    launches = dict(K.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ligands.sdf")
        write_sdf(path, mols)
        n_records = open(path).read().count("$$$$")
    n_atoms = [m.n_atoms for m in mols]
    connected = np.mean([len(m.fragments()) == 1 for m in mols])
    n_lig = int(sum(len(s) for s in sizes))
    log(f"[main] {len(pockets)} pockets x {N_SAMPLES} samples, T={T_MAIN}: "
        f"seconds per pocket {[round(s, 3) for s in seconds]}, "
        f"{n_lig / sum(seconds):.3f} ligands/s; {len(mols)} molecules "
        f"built ({n_records} SDF records, atoms {min(n_atoms)}-"
        f"{max(n_atoms)}, single-fragment share {connected:.3f}); "
        f"outputs finite: {finite}; launches {launches}")
    # per forward and layer: one gcl_messages, and one edge_vector_reduce
    # launch that takes the difference and the cross weight set together
    per_batch = {"gcl_messages": (T_MAIN + 1) * model.cfg.egnn.n_layers,
                 "edge_vector_reduce":
                     (T_MAIN + 1) * model.cfg.egnn.n_layers}
    want = {k: v * len(pockets) for k, v in per_batch.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not finite or len(mols) != n_lig or n_records != n_lig:
        raise AssertionError("main path outputs are incomplete")
    return launches


def event_noise(torch, model, sizes, steps):
    """Fixed noise for a guided trajectory: that of ``fixed_noise`` plus
    the draws of every guidance event the config fires."""
    from diffndm_tpu_torch.diffusion.sampler import guidance_events

    cfg = model.sample_cfg
    base = fixed_noise(torch, model, sizes, steps)
    rng = np.random.default_rng(SEED + 2)
    shape = tuple(base.init.shape)
    g_extra, k = cfg.atp.num_groups - 1, cfg.spsa.num_probes

    def normal(*shp):
        return torch.from_numpy(rng.standard_normal(shp).astype(np.float32))

    events = guidance_events(cfg, steps)
    return base._replace(
        atp={s: normal(g_extra, *shape) for s in events["atp"]},
        spsa={s: normal(k, *shape[:2], 3) for s in events["spsa"]},
        hybrid=(normal(g_extra, *shape), normal(g_extra, k, *shape[:2], 3)))


def guided_path_check(torch, make_model, pair):
    """The same fixed-noise guided trajectory (prunes, SPSA updates and
    the hybrid all fire) on the card and on the CPU: the same rows must
    survive, with the same atom types, at the same coordinates."""
    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)

    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(enabled=True, **GUIDED_CHECK["spsa"]),
                       atp=ATPConfig(enabled=True, **GUIDED_CHECK["atp"]))
    sizes = np.array([12, 18, 9, 24])
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model(device, cfg)
        pocket = model.pocket_from_dataset(pair, len(sizes))
        noise = event_noise(torch, model, sizes, T_GUIDED_CHECK)
        res = model.sample_given_pocket(pocket, sizes,
                                        timesteps=T_GUIDED_CHECK, noise=noise)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask, res.row_src)]
    (xg, hg, mg, rg), (xc, hc, mc, rc) = out["cuda"], out["cpu"]
    same_rows = bool(torch.equal(rg, rc) and torch.equal(mg, mc))
    err = float((xg - xc).abs().max()) if same_rows else float("inf")
    m = mc > 0.5
    same_types = same_rows and bool(
        torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    log(f"[guided] path check, T={T_GUIDED_CHECK} fixed noise, "
        f"B={len(sizes)}: surviving rows cuda {rg.tolist()} cpu "
        f"{rc.tolist()}; max |x_cuda - x_cpu| = {err:.3e} A (atol "
        f"{PATH_COORD_ATOL}); atom types identical: {same_types}")
    if not (same_rows and same_types and err <= PATH_COORD_ATOL):
        raise AssertionError("the guided kernel path disagrees with the "
                             "guided plain path")


def guided_phase(torch, K, model, pockets, sizes):
    """The guided main path.  Returns its launch counts, the kernel calls
    of its first fused SPSA forward and the first population of that size
    it scored."""
    from diffndm_tpu_torch.diffusion.sampler import (count_forwards,
                                                     guidance_events)

    cfg, oracle = model.sample_cfg, model.oracle
    n_layers = model.cfg.egnn.n_layers
    fan_out = 2 * cfg.spsa.num_probes * N_SAMPLES
    calls, populations = [], []
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            a = args[0][0] if name.endswith("_pair") else args[0]
            if a.shape[0] == fan_out and \
                    sum(c[0] == name for c in calls) < n_layers:
                calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    score = oracle.score_batch_types

    def recording_score(coords, types, mask, weights):
        if len(coords) == fan_out and not populations:
            populations.append((coords.copy(), types.copy(), mask.copy(),
                                weights))
        return score(coords, types, mask, weights)

    for n in WRAPPERS:
        setattr(K, n, recorder(n))
    oracle.score_batch_types = recording_score
    K.reset_launches()
    oracle.reset_counts()
    mols, seconds, finite = [], [], True
    try:
        for pocket, n_lig in zip(pockets, sizes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = torch.Generator(device=model.device).manual_seed(SEED)
            res = model.sample_given_pocket(pocket, n_lig, timesteps=T_MAIN,
                                            generator=g)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            finite &= all(bool(torch.isfinite(v).all()) for v in
                          (res.ligand.x, res.ligand.h, res.pocket.x))
            expect = (N_SAMPLES, -(-int(max(n_lig)) // 8) * 8, 3)
            if tuple(res.ligand.x.shape) != expect:
                raise AssertionError(f"ligand shape "
                                     f"{tuple(res.ligand.x.shape)} != "
                                     f"{expect}")
            if not np.array_equal(
                    np.asarray(n_lig)[res.row_src.cpu().numpy()],
                    res.ligand.mask.sum(1).cpu().numpy()):
                raise AssertionError("a surviving row's mask is not its "
                                     "origin row's")
            mols += model.result_to_molecules(res)
    finally:
        del oracle.score_batch_types
        for n, f in originals.items():
            setattr(K, n, f)
    launches = dict(K.LAUNCHES)

    events = guidance_events(cfg, T_MAIN)
    forwards = count_forwards(cfg, T_MAIN)
    g_extra = cfg.atp.num_groups - 1
    per_spsa = 1 if cfg.spsa.fuse_probes else cfg.spsa.num_probes
    scorings = (per_spsa * len(events["spsa"]) + 2 * len(events["atp"])
                + (2 + g_extra * per_spsa) * len(events["hybrid"]))
    n_lig = int(sum(len(s) for s in sizes))
    wall = sum(seconds)
    log(f"[guided] {len(pockets)} pockets x {N_SAMPLES} samples, T={T_MAIN}, "
        f"SPSA k={cfg.spsa.num_probes} + ATP G={cfg.atp.num_groups}: events "
        f"per pocket batch {dict((k, len(v)) for k, v in events.items())}, "
        f"{forwards} forwards; seconds per pocket batch "
        f"{[round(s, 3) for s in seconds]}, {n_lig / wall:.3f} ligands/s; "
        f"oracle: {oracle.n_calls} calls, {oracle.n_scored} molecules, "
        f"{oracle.seconds:.3f} s = {oracle.seconds / wall:.3f} of the wall "
        f"time, invalid rate {oracle.invalid_rate:.3f}, rows scored in "
        f"Python {oracle.n_python_rows}; {len(mols)} molecules built; "
        f"outputs finite: {finite}; launches {launches}")
    want = {k: forwards * n_layers * len(pockets) for k in launches}
    if launches != want:
        raise AssertionError(f"guided launch counts {launches} != {want}")
    if oracle.n_calls != scorings * len(pockets):
        raise AssertionError(f"{oracle.n_calls} reward calls, expected "
                             f"{scorings * len(pockets)}")
    if not finite or len(mols) != n_lig:
        raise AssertionError("guided path outputs are incomplete")
    if len(populations) != 1 or any(
            sum(c[0] == n for c in calls) != n_layers
            for n in ("gcl_messages", "edge_vector_reduce_pair")):
        raise AssertionError("no fused SPSA forward was captured")
    return launches, calls, populations[0], seconds


def fanout_phase(torch, K, calls):
    """Both kernels against their plain versions on the captured calls of
    one fused SPSA forward (every layer's call compared, the first timed)."""
    results = {}
    for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
        mine = [c for c in calls if c[0] == wrapper]
        res = check_calls(torch, K, wrapper, mine, reps=20)
        results[WRAPPERS[wrapper]] = res
        log(f"[kernels] fan-out {wrapper} {res['shape']} ({len(mine)} calls "
            f"of a fused SPSA forward checked, atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}): {describe(res)}")
    return results


def oracle_phase(model, population):
    """The native scorer against the Python scorer on one fan-out
    population of the guided run."""
    from diffndm_tpu_torch.guidance.oracle import RewardOracle

    coords, types, mask, weights = population
    python = RewardOracle(model.dataset_info, scorer="python")
    native = RewardOracle(model.dataset_info, scorer="native")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        r_nat = native.score_batch_types(coords, types, mask, weights)
        times.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    r_py = python.score_batch_types(coords, types, mask, weights)
    py_ms = 1e3 * (time.perf_counter() - t0)
    equal = bool(np.array_equal(r_nat, r_py))
    log(f"[oracle] one fused SPSA population of {len(coords)} molecules "
        f"({int((r_nat > 0).sum())} valid): native rewards equal the Python "
        f"scorer's bit for bit: {equal}; native {np.median(times):.2f} ms, "
        f"Python {py_ms:.1f} ms per {len(coords)} molecules (host, one "
        f"thread)")
    if not equal:
        raise AssertionError("the native scorer disagrees with the Python "
                             "scorer")


def quality_rows(torch, ds, models, seed):
    """One evaluation by the JAX package's guided-lift protocol: per model
    the summary row, and per pocket the single-fragment count and the
    number of distinct input rows its 16 ligands descend from (a global
    top-B prune replicates candidates, so a guided pocket batch can end as
    the offspring of a few rows)."""
    from diffndm_tpu_torch.chem.metrics import quality_summary

    picks = np.random.default_rng(0).choice(
        len(ds), size=N_QUALITY_POCKETS, replace=False)
    rows = {}
    for label, model in models.items():
        g_sizes = torch.Generator().manual_seed(seed)
        g = torch.Generator(device=model.device).manual_seed(seed)
        mols, connected, origins, t0 = [], [], [], time.perf_counter()
        for pi in picks:
            pocket = model.pocket_from_dataset(ds[int(pi)], N_SAMPLES)
            sizes = np.maximum(model.sample_ligand_sizes(pocket, g_sizes),
                               MIN_LIGAND_ATOMS)
            res = model.sample_given_pocket(pocket, sizes, timesteps=T_MAIN,
                                            generator=g)
            batch = model.result_to_molecules(res)
            connected.append(sum(len(m.fragments()) == 1 for m in batch))
            origins.append(len(set(res.row_src.tolist())))
            mols += batch
        torch.cuda.synchronize()
        rows[label] = dict(quality_summary(mols),
                           seconds=time.perf_counter() - t0)
        ref = JAX_ROWS[label]
        log(f"[quality] seed {seed} {label:8s} n={rows[label]['n']} in "
            f"{rows[label]['seconds']:.1f} s: "
            + ", ".join(f"{k} {rows[label][k]:.3f} (JAX {ref[k]:.3f})"
                        for k in ref)
            + f", logp {rows[label]['logp']:.3f}, lipinski "
            f"{rows[label]['lipinski']:.2f}; per pocket: single-fragment "
            f"ligands {connected}, distinct origin rows {origins}")
    return rows


def quality_spread(torch, ds, models):
    """The evaluation over QUALITY_SPREAD_SEEDS seeds: how far each metric
    moves with the random stream alone, which is what a difference between
    two builds of the kernels has to exceed."""
    runs = [quality_rows(torch, ds, models, SEED + 1 + i)
            for i in range(QUALITY_SPREAD_SEEDS)]
    for label in models:
        log(f"[quality] {label} over {len(runs)} seeds, min-max: "
            + ", ".join(f"{k} {min(r[label][k] for r in runs):.3f}-"
                        f"{max(r[label][k] for r in runs):.3f}"
                        for k in JAX_ROWS[label]))


def quality_phase(torch, ds, models):
    """The JAX package's guided-lift evaluation protocol on the card."""
    rows = quality_rows(torch, ds, models, SEED + 1)
    lifts = {k: rows["guided"][k] - rows["unguided"][k] for k in LIFT_FLOORS}
    log(f"[quality] guided lift: QED {lifts['qed']:+.3f} (JAX +0.105), SA "
        f"{lifts['sa']:+.3f} (JAX +0.244); floors {QUALITY_FLOORS}, lift "
        f"{LIFT_FLOORS}")
    missed = [f"{label} {k} {rows[label][k]:.3f} < {v}"
              for label, floors in QUALITY_FLOORS.items()
              for k, v in floors.items() if not rows[label][k] >= v]
    missed += [f"{k} lift {lifts[k]:.3f} < {v}"
               for k, v in LIFT_FLOORS.items() if not lifts[k] >= v]
    if missed:
        raise AssertionError(f"sample quality below its floors: {missed}")
    return rows


def step_phase(torch, K, model, pocket, sizes):
    """A T_STEP-step stretch of the sampler: CUDA events around every
    kernel wrapper call (the kernels on the loop's own, cold inputs), a
    host clock around the stretch, and a profiler trace of a second
    stretch for the device's busy time."""
    originals = {n: getattr(K, n) for n in WRAPPERS}
    events = {n: [] for n in WRAPPERS}

    def timed(name):
        def fn(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return fn

    def stretch():
        g = torch.Generator(device=model.device).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample_given_pocket(pocket, sizes, timesteps=T_STEP,
                                  generator=g)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    stretch()                                   # warm
    plain_wall = stretch()
    for n in WRAPPERS:
        setattr(K, n, timed(n))
    try:
        timed_wall = stretch()
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    forwards = T_STEP + 1
    per_step = {n: sum(a.elapsed_time(b) for a, b in ev) / forwards
                for n, ev in events.items() if ev}
    per_call = {n: per_step[n] * forwards / len(events[n]) for n in per_step}
    log(f"[step] {T_STEP} steps ({forwards} forwards), B={len(sizes)}: "
        f"{plain_wall / forwards:.4f} ms per step by the host clock "
        f"({timed_wall / forwards:.4f} with the events); kernel wrapper ms "
        f"per step inside the loop "
        f"{ {n: round(v, 4) for n, v in per_step.items()} }, sum "
        f"{sum(per_step.values()):.4f}; ms per call "
        f"{ {n: round(v, 4) for n, v in per_call.items()} } (events "
        f"around the wrapper: launch gaps included)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = stretch()
    busy_us, ours_us, n_dev = 0.0, 0.0, 0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            n_dev += 1
            if "edge_chain" in ev.name:
                ours_us += dur
    if n_dev == 0 or busy_us <= 0:
        log("[step] the profiler recorded no device activity: idle share "
            "not measured")
        return
    busy = busy_us / 1e3
    log(f"[step] profiler over {T_STEP} steps: {n_dev} device activities "
        f"({n_dev / forwards:.1f} per step), device busy "
        f"{busy / forwards:.4f} ms per step of which the edge-chain "
        f"kernels {ours_us / 1e3 / forwards:.4f}; wall "
        f"{prof_wall / forwards:.4f} ms per step while profiled; idle "
        f"share {1 - busy / prof_wall:.3f} (against the unprofiled wall: "
        f"{1 - busy / plain_wall:.3f})")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["kernels", "phases", "quality"],
                        default=None, help="stop after the kernel phase, "
                        "print the kernels' cycles per phase, or run the "
                        "quality evaluation alone over several seeds")
    opts = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    from diffndm_tpu_torch.chem import native
    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.ops import egnn_kernels as K

    smi = nvidia_smi()
    log(f"[identity] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # the two compilers side by side
        builds = [pool.submit(K.build_library),
                  pool.submit(native.build_library)]
        so, scorer_so = (b.result() for b in builds)
    log(f"[identity] kernels and reward scorer built in "
        f"{time.perf_counter() - t0:.1f} s: {os.path.relpath(so, REPO)}, "
        f"{os.path.relpath(scorer_so, REPO)}")
    # the compiler's report, per instantiation edge_chain_mma<H, VEC>
    kernel = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_mmaILi(\d+)"
                      r"ELb([01])E", line)
        if m:
            name = "edge_vector_reduce" if m[2] == "1" else "gcl_messages"
            kernel = f"{name} H={int(m[1])}"
        elif kernel and ("registers" in line or "spill" in line):
            log(f"[ptxas] {kernel}: {line.split(':')[-1].strip()}")

    hist = np.load(os.path.join(DATA, "size_distribution.npy"))
    unguided_cfg = SampleConfig(pocket_pad_multiple=16)
    guided_cfg = SampleConfig(pocket_pad_multiple=16,
                              spsa=SPSAConfig(enabled=True),
                              atp=ATPConfig(enabled=True))

    def make_model(device, sample_cfg=unguided_cfg):
        model = DiffNDM.from_yaml(
            os.path.join(RUN, "hparams.yaml"), device=device,
            size_histogram=hist, sample_cfg=sample_cfg, scorer="native")
        model.load_params_npz(WEIGHTS)
        return model

    model = make_model("cuda")
    ds = ProcessedLigandPocketDataset(os.path.join(DATA, "test.npz"))
    pockets = [model.pocket_from_dataset(ds[i], N_SAMPLES) for i in POCKETS]
    g = torch.Generator().manual_seed(SEED)
    sizes = [model.sample_ligand_sizes(p, g) for p in pockets]

    if opts.only == "phases":
        phase_cycles(torch, K, model, pockets[0], sizes[0])
        return 0
    if opts.only == "quality":
        quality_spread(torch, ds, {"unguided": model, "guided": make_model(
            "cuda", guided_cfg)})
        return 0
    results = kernel_phase(torch, K, model, pockets[0], sizes[0])
    if opts.only == "kernels":
        log("[kernels] done (--only kernels: no result)")
        return 0
    path_check(torch, make_model, ds[POCKETS[0]])
    launches = main_path(torch, K, model, pockets, sizes)

    guided = make_model("cuda", guided_cfg)
    guided_path_check(torch, make_model, ds[POCKETS[0]])
    guided_launches, calls, population, _ = guided_phase(
        torch, K, guided, pockets, sizes)
    fanout = fanout_phase(torch, K, calls)
    del calls
    oracle_phase(guided, population)
    quality_phase(torch, ds, {"unguided": model, "guided": guided})
    step_phase(torch, K, model, pockets[0], sizes[0])

    table = [dict(name=name, route="cuda", source=SOURCE, replaces=src,
                  launches=launches[name],
                  max_abs_err=results[name]["max_abs_err"],
                  ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
                  bound_ms=results[name]["bound_ms"],
                  bound_by=results[name]["bound_by"], library_ms=None,
                  bound_peak="tf32 495 TFLOP/s, 3.35 TB/s",
                  entry=results[name]["entry"],
                  shape=results[name]["shape"],
                  guided_launches=guided_launches[name],
                  fanout={k: fanout[name][k] for k in (
                      "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "blocks", "rows_per_block")})
             for name, src in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
