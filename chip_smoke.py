#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any fault or mismatch:

1. identity: the card (nvidia-smi name and power limit) and the build of
   the CUDA kernels from diffndm_tpu_torch/csrc;
2. kernels: each EGNN edge-chain kernel against its plain PyTorch version
   on the card, on the inputs the main path gives it (captured from one
   denoiser forward) and at the flagship shapes of
   configs/crossdock_fullatom_cond.yml (B=20, N=344, H=256, 5 A cutoff);
   kernel time, plain time and the card's bound for the same work;
3. path check: a 10-step fixed-noise trajectory through the kernels on
   the card against the plain path on the CPU;
4. main path: 2 test pockets x 16 samples at T=500 from the committed
   v3b EMA weights, molecules built and written as SDF, with the kernel
   launch counts of that run.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

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
N_SAMPLES, T_MAIN, T_CHECK = 16, 500, 10
SEED = 0

# published H100 SXM peaks (fp32 outside the tensor cores, HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# kernel vs plain on the card: both fp32, sums in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# path check: ten steps of fp32 forwards on two devices
PATH_COORD_ATOL = 1e-3       # Angstrom

KERNELS = {
    "gcl_messages": "diffndm_tpu/ops/pallas_egnn.py:151",
    "edge_vector_reduce": "diffndm_tpu/ops/pallas_egnn.py:269",
}
SOURCE = "diffndm_tpu_torch/csrc/egnn_edge.cu"


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
    adjacency among the rows computed; each input read once, the output
    written once."""
    a, adj = args[0], args[4]
    bsz, n, h = a.shape
    rows = kw.get("n_rows") or n
    edges = int((adj[:, :rows] != 0).sum())
    per_edge = 2 * h * h + 2 * h + (2 * h if name == "gcl_messages" else 30)
    node = bsz * rows * h + bsz * n * h
    planes = 3 * bsz * rows * n
    weights = h * h + 5 * h
    if name == "gcl_messages":
        out = bsz * n * h
        extra = 0
    else:
        out = bsz * n * 3
        extra = bsz * n * 3 + bsz * 3
    return edges * per_edge, 4 * (node + planes + weights + extra + out)


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(torch, fn, reps, warmup=3):
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(torch, name, out, ref):
    err = (out - ref).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
    if not bool(torch.isfinite(out).all()) or bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs "
            f"{max_abs:.3e}, {int(bad.sum())} elements beyond atol "
            f"{KERNEL_ATOL} + rtol {KERNEL_RTOL}")
    return max_abs, max_rel


def check_kernel(torch, K, name, args, kw, reps):
    kernel = getattr(K, name)
    plain = getattr(K, name + "_plain")
    out = kernel(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    max_abs, max_rel = compare(torch, name, out, ref)
    ms = time_ms(torch, lambda: kernel(*args, **kw), reps)
    plain_ms = time_ms(torch, lambda: plain(*args, **kw), max(3, reps // 10),
                       warmup=1)
    b_ms, b_by = bound_ms(*call_cost(name, args, kw))
    return dict(max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def capture_kernel_calls(torch, K, model, pocket, sizes):
    """The kernel calls of one denoiser forward on the main path's first
    state (t = 1): the wrappers' arguments, recorded as given."""
    calls = []
    originals = {n: getattr(K, n) for n in KERNELS}

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
    for n in KERNELS:
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
    return (common + [t(x), t(center), we, w2, b2, wvec],
            dict(cross=True, n_rows=nl))


def kernel_phase(torch, K, model, pocket, sizes):
    calls = capture_kernel_calls(torch, K, model, pocket, sizes)
    counts = {n: sum(1 for c in calls if c[0] == n) for n in KERNELS}
    log(f"[kernels] captured one forward's calls: {counts}")
    results = {}
    for name in KERNELS:
        mine = [c for c in calls if c[0] == name]
        errs = []
        for _, args, kw in mine:
            out = getattr(K, name)(*args, **kw)
            torch.cuda.synchronize()
            errs.append(compare(torch, name, out,
                                getattr(K, name + "_plain")(*args, **kw)))
        _, args, kw = mine[0]
        res = check_kernel(torch, K, name, args, kw, reps=50)
        res["max_abs_err"] = max(e[0] for e in errs)
        res["max_rel_err"] = max(e[1] for e in errs)
        res["shape"] = list(args[0].shape)
        results[name] = res
        log(f"[kernels] main path {name} {res['shape']} ({len(mine)} calls "
            f"checked): max abs {res['max_abs_err']:.3e} max rel "
            f"{res['max_rel_err']:.3e} (atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}); kernel {res['ms']:.4f} ms, plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']})")
    flagship = {}
    for name in KERNELS:
        args, kw = flagship_inputs(torch, name, model.device)
        res = check_kernel(torch, K, name, args, kw, reps=10)
        res["shape"] = list(args[0].shape)
        flagship[name] = res
        log(f"[kernels] flagship {name} {res['shape']} {kw}: max abs "
            f"{res['max_abs_err']:.3e} max rel {res['max_rel_err']:.3e}; "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return results, flagship


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
    per_batch = {"gcl_messages": (T_MAIN + 1) * model.cfg.egnn.n_layers,
                 "edge_vector_reduce":
                     (T_MAIN + 1) * model.cfg.egnn.n_layers * 2}
    want = {k: v * len(pockets) for k, v in per_batch.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not finite or len(mols) != n_lig or n_records != n_lig:
        raise AssertionError("main path outputs are incomplete")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.ops import egnn_kernels as K

    smi = nvidia_smi()
    log(f"[identity] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = K.build_library()
    log(f"[identity] kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(so, REPO)}")
    # the compiler's report, per instantiation edge_chain_kernel<H/16, VEC>
    kernel = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_kernelILi(\d+)"
                      r"ELb([01])E", line)
        if m:
            name = "edge_vector_reduce" if m[2] == "1" else "gcl_messages"
            kernel = f"{name} H={16 * int(m[1])}"
        elif kernel and ("registers" in line or "spill" in line):
            log(f"[ptxas] {kernel}: {line.split(':')[-1].strip()}")

    hist = np.load(os.path.join(DATA, "size_distribution.npy"))

    def make_model(device):
        model = DiffNDM.from_yaml(
            os.path.join(RUN, "hparams.yaml"), device=device,
            size_histogram=hist,
            sample_cfg=SampleConfig(pocket_pad_multiple=16))
        model.load_params_npz(WEIGHTS)
        return model

    model = make_model("cuda")
    ds = ProcessedLigandPocketDataset(os.path.join(DATA, "test.npz"))
    pockets = [model.pocket_from_dataset(ds[i], N_SAMPLES) for i in POCKETS]
    g = torch.Generator().manual_seed(SEED)
    sizes = [model.sample_ligand_sizes(p, g) for p in pockets]

    results, _ = kernel_phase(torch, K, model, pockets[0], sizes[0])
    path_check(torch, make_model, ds[POCKETS[0]])
    launches = main_path(torch, K, model, pockets, sizes)

    table = [dict(name=name, route="cuda", source=SOURCE, replaces=src,
                  launches=launches[name],
                  max_abs_err=results[name]["max_abs_err"],
                  ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
                  bound_ms=results[name]["bound_ms"],
                  bound_by=results[name]["bound_by"], library_ms=None)
             for name, src in KERNELS.items()]
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
