#!/usr/bin/env python3
"""Gate and time several builds of the forward kernels on one NVIDIA GPU.

    python3 scripts/forward_build_ab.py [--bf16 [--path] [--profile]]
        [--order a,b,...] [LABEL=SOURCE ...]
    python3 scripts/forward_build_ab.py --unpack LABEL=REV

Each LABEL=SOURCE names another copy of ``csrc/egnn_edge.cu`` (with its
``egnn_*.cuh`` headers beside it, and, where the copy packs W2 for its bf16
kernel in another layout, that copy's ``egnn_kernels.py``); the label
``change`` is the checkout's own source.  ``--unpack parent=HEAD~1``
writes a commit's ``csrc/`` and ``ops/egnn_kernels.py`` (from ``git
show``) to ``build/ab/parent/``, to be named as
``parent=build/ab/parent/egnn_edge.cu`` in a later call on the card (whose
copy of the repository has no ``.git``).  All builds are compiled side by
side first, and the compiler's register and spill report of each is
printed.  For each build in the order given (default: every build, then
again in reverse) the script runs captured calls of both wrappers.  One
JSON line per (build, case, wrapper) goes to the standard output and to
``chiprun_out/forward_build_ab.jsonl`` (``_bf16.jsonl`` with ``--bf16``).

fp32 (default): the kernel calls of real first denoiser forwards at full
width on seeded random weights (chip_smoke.py's ``seeded_model``):

- ``<config> joint``: the joint sampler's first forward (t = T, joint
  noise, 16 rows at sizes of the size prior, every row moving) of each
  joint config;
- ``<config> cond``: the conditional sampler's first state of
  virtual_cond (H = 128), virtual_cond_v3b (H = 192) and
  crossdock_fullatom_cond (H = 256), 16 rows on test pocket 220 written as
  PDB + SDF.

Per case: the largest share of the gate atol 1e-5 + rtol 1e-4 against the
plain version that any output element uses (over 1 fails chip_smoke.py),
and the device ms of the case's first call (chip_smoke.py's ``time_ms``).

``--bf16``: the calls of chip_smoke.py's [modes] (a), in bf16: a bf16 v3b
forward [16, 80, 192] (v3b's EMA weights, test pocket 220), the joint
sampler's first forward of crossdock_fullatom_joint [16, 584, 128] and the
flagship shapes [20, 344, 256].  Per case and build: the bf16 entry's
largest share of chip_smoke.py's bf16 gate (BF16_GATE of the largest plain
element + BF16_ATOL) over the case's calls, its device ms beside the
tensor bound and the special-function floor (``sfu_floor_ms``), the rows
per block the build picks, and the fp32 entry on the same calls, its ms and
whether its outputs equal the first build's to the bit.  Beside the
compiler's report, each kernel's SASS (``cuobjdump -sass``): its HGMMA
instructions, and for the fp32 kernels whether the SASS equals the first
build's.  ``--path`` adds, per build, [modes] (b)'s 10-step
fixed-noise bf16 trajectory on the card against the CPU's plain bf16 run
(gate BF16_PATH_ATOL, atom types equal).  ``--profile`` also builds each
source with -DEGNN_PROFILE and prints where the blocks of each case's
first bf16 call spend their cycles.
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
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "diffndm_tpu_torch/csrc"
OPS = "diffndm_tpu_torch/ops/egnn_kernels.py"
COND_CASES = ("virtual_cond", "virtual_cond_v3b", "crossdock_fullatom_cond")
WRAPPERS = ("gcl_messages", "edge_vector_reduce_pair")
B = 16


def unpack(item):
    """Write REV's csrc/ files and its ops/egnn_kernels.py (whose W2
    packing a build of that csrc/ reads) under build/ab/LABEL/ with git
    show."""
    label, rev = item.split("=", 1)
    dest = os.path.join(REPO, "build", "ab", label)
    os.makedirs(dest, exist_ok=True)
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{CSRC}"],
                           cwd=REPO, check=True, capture_output=True,
                           text=True).stdout.split()
    paths = [f"{CSRC}/{name}" for name in names] + [OPS]
    for path in paths:
        data = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=REPO,
                              check=True, capture_output=True).stdout
        with open(os.path.join(dest, os.path.basename(path)), "wb") as f:
            f.write(data)
    print(f"{label}: {rev}'s {CSRC} and {OPS} in "
          f"{os.path.relpath(dest, REPO)}")


def bf16_packer(source, default):
    """The ``pack_w2_bf16`` of the egnn_kernels.py beside ``source`` (its
    build's layout of W2), else ``default``."""
    import importlib.util

    path = os.path.join(os.path.dirname(source), "egnn_kernels.py")
    if not os.path.exists(path):
        return default
    spec = importlib.util.spec_from_file_location(
        "ab_" + os.path.basename(os.path.dirname(source)), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.pack_w2_bf16


def ptxas_report(so):
    """{'gcl_messages H=128': 'Used 230 registers, ...; 0 bytes spill
    stores, ...'} from the build's compiler log (``_bf16``: the bf16
    kernel, edge_chain_wgmma, or an earlier template's BF argument)."""
    out, kernel = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_(w?gmma|mma)"
                      r"ILi(\d+)ELb([01])E(?:Lb([01])E)?", line)
        if m:
            name = "edge_vector_reduce" if m[3] == "1" else "gcl_messages"
            bf16 = m[1] == "wgmma" or m[4] == "1"
            kernel = f"{name}{'_bf16' if bf16 else ''} H={int(m[2])}"
        elif kernel and ("registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.split(":")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def ptxas_losses(so):
    """The compiler's "Potential Performance Loss" notes (wgmma
    serialised, and why), by kernel as ptxas_report names them."""
    out = []
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Performance Loss: (.*) in the function .*edge_chain_"
                      r"(w?gmma|mma)ILi(\d+)ELb([01])E", line)
        if m:
            name = "edge_vector_reduce" if m[4] == "1" else "gcl_messages"
            bf16 = "_bf16" if m[2] == "wgmma" else ""
            out.append(f"{name}{bf16} H={int(m[3])}: {m[1]}")
    return out


def sass(so):
    """{'gcl_messages H=128' (as ptxas_report names them): the kernel's
    SASS instructions} from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, kernel = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : .*edge_chain_(w?gmma|mma)ILi(\d+)"
                      r"ELb([01])E(?:Lb([01])E)?", line)
        if m:
            name = "edge_vector_reduce" if m[3] == "1" else "gcl_messages"
            bf16 = m[1] == "wgmma" or m[4] == "1"
            kernel = f"{name}{'_bf16' if bf16 else ''} H={int(m[2])}"
            out[kernel] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", line)
        if kernel and m:
            out[kernel].append(m[1])
    return out


def capture(torch, K, cs, ds, tmp):
    """{case: kernel calls of its first forward}."""
    from diffndm_tpu_torch.constants import dataset_params

    cases = {}
    for name in ("crossdock_fullatom_joint", "moad_ca_joint",
                 "moad_fullatom_joint", "crossdock_ca_joint"):
        model = cs.seeded_model(torch, os.path.join(
            REPO, "configs", name + ".yml"), "cuda")
        cases[f"{name} joint"] = cs.joint_first_calls(torch, K, model, B)
    pdb, sdf = cs.write_pocket_files(ds[cs.CLI_POCKET], dataset_params[
        "crossdock_full"]["atom_decoder"], tmp)
    for name in COND_CASES:
        model = cs.seeded_model(torch, os.path.join(
            REPO, "configs", name + ".yml"), "cuda")
        pocket = model.pocket_from_pdb(pdb, sdf, B)
        sizes = model.sample_ligand_sizes(
            pocket, torch.Generator().manual_seed(cs.SEED))
        cases[f"{name} cond"] = cs.capture_kernel_calls(torch, K, model,
                                                        pocket, sizes)
    return cases


def v3b_maker(torch, cs):
    """chip_smoke.py's v3b model on its EMA weights, on a device."""
    import numpy as np

    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.model import DiffNDM

    hist = np.load(os.path.join(cs.DATA, "size_distribution.npy"))

    def make(device):
        model = DiffNDM.from_yaml(
            os.path.join(cs.RUN, "hparams.yaml"), device=device,
            size_histogram=hist,
            sample_cfg=SampleConfig(pocket_pad_multiple=16), scorer="python")
        model.load_params_npz(cs.WEIGHTS)
        return model
    return make


def capture_bf16(torch, K, cs, ds, make):
    """{case: bf16 kernel calls}, those of chip_smoke.py's [modes] (a)."""
    model = cs.with_egnn(make("cuda"), compute_dtype="bfloat16")
    pocket = model.pocket_from_dataset(ds[cs.POCKETS[0]], cs.N_SAMPLES)
    sizes = model.sample_ligand_sizes(pocket,
                                      torch.Generator().manual_seed(cs.SEED))
    joint = cs.with_egnn(cs.seeded_model(torch, cs.JOINT_CONFIG, "cuda"),
                         compute_dtype="bfloat16")
    cases = {"v3b": cs.capture_kernel_calls(torch, K, model, pocket, sizes),
             "joint": cs.joint_first_calls(torch, K, joint, cs.JOINT_B),
             "flagship": [(w, *cs.flagship_inputs(torch, w, "cuda"))
                          for w in WRAPPERS]}
    bf16 = {}
    for case, calls in cases.items():
        bf16[case] = [(w, a, dict(kw, compute_dtype="bfloat16"))
                      for w, a, kw in calls if w in WRAPPERS]
    return bf16


def share(out, ref, cs):
    return float(((out - ref).abs()
                  / (cs.KERNEL_ATOL + cs.KERNEL_RTOL * ref.abs())).max())


def bf16_share(out, ref, cs):
    return float((out - ref).abs().max()) / (
        cs.BF16_GATE * float(ref.abs().max()) + cs.BF16_ATOL)


def shape_of(wrapper, args):
    return list((args[0][0] if wrapper.endswith("_pair") else args[0]).shape)


def fp32_rows(torch, K, cs, cases, refs, order, use):
    rows = []
    for label in order:
        use(label)
        for case, calls in cases.items():
            for wrapper in WRAPPERS:
                mine = [(c, r) for c, r in zip(calls, refs[case])
                        if c[0] == wrapper]
                fn = getattr(K, wrapper)
                worst = max(share(fn(*a, **kw), r, cs)
                            for (_, a, kw), r in mine)
                _, args, kw = mine[0][0]
                row = dict(build=label, case=case, wrapper=wrapper,
                           shape=shape_of(wrapper, args),
                           calls=len(mine), tolerance_share=worst,
                           ms=cs.time_ms(torch, lambda: fn(*args, **kw), 20),
                           bound_ms=cs.bound_ms(*cs.call_cost(wrapper, args,
                                                              kw))[0])
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def max_sm_clock_hz():
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return float(mhz) * 1e6


def sfu_floor_ms(torch, wrapper, args, kw, clock_hz):
    """The special-function floor of a bf16 call: two silu per (edge, k),
    of z and of m, each an ex2 and a reciprocal on the special-function
    units (16 results per SM per clock), per weight set, over the edges
    with a nonzero adjacency among the rows computed, at the card's
    largest SM clock."""
    pair = wrapper.endswith("_pair")
    a, adj = (args[0][0] if pair else args[0]), args[4]
    n, h = a.shape[1], a.shape[2]
    rows = kw.get("n_rows")
    rows = n if rows is None else max(0, min(n, rows))
    edges = int((adj[:, :rows] != 0).sum())
    ops = edges * 4 * h * (2 if pair else 1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * ops / (16 * n_sm * clock_hz)


def bf16_rows(torch, K, cs, cases, order, use, path_ref, make, ds,
              profile):
    refs = {case: [getattr(K, w + "_plain")(*a, **kw) for w, a, kw in calls]
            for case, calls in cases.items()}
    clock_hz = max_sm_clock_hz()
    first_fp32 = {}
    rows = []
    for label in order:
        use(label)
        for case, calls in cases.items():
            for wrapper in WRAPPERS:
                mine = [(c, r) for c, r in zip(calls, refs[case])
                        if c[0] == wrapper]
                fn = getattr(K, wrapper)
                worst, fp32_equal = 0.0, True
                for i, ((_, a, kw), r) in enumerate(mine):
                    worst = max(worst, bf16_share(fn(*a, **kw), r, cs))
                    out32 = fn(*a, **dict(kw, compute_dtype="float32"))
                    key = (case, wrapper, i)
                    first_fp32.setdefault(key, out32)
                    fp32_equal &= bool(torch.equal(out32, first_fp32[key]))
                _, args, kw = mine[0][0]
                kw32 = dict(kw, compute_dtype="float32")
                shape = shape_of(wrapper, args)
                ops, nbytes = cs.call_cost(wrapper, args, kw)
                row = dict(
                    build=label, case=case, wrapper=wrapper, shape=shape,
                    calls=len(mine), bf16_gate_share=worst,
                    ms=cs.time_ms(torch, lambda: fn(*args, **kw), 20),
                    fp32_ms=cs.time_ms(torch, lambda: fn(*args, **kw32), 20),
                    fp32_bits_equal_first_build=fp32_equal,
                    bound_ms=1e3 * max(ops / cs.PEAK_BF16_FLOPS,
                                       nbytes / cs.PEAK_BYTES),
                    sfu_floor_ms=sfu_floor_ms(torch, wrapper, args, kw,
                                              clock_hz),
                    rows_per_block=K.launch_grid(wrapper, *shape,
                                                 kw.get("n_rows"),
                                                 "bfloat16")[1])
                rows.append(row)
                print(json.dumps(row), flush=True)
        if path_ref is not None:
            err, same = cs.bf16_path_error(torch, cs.bf16_fixed_run(
                torch, make, ds[cs.POCKETS[0]], "cuda"), path_ref)
            row = dict(build=label, case="path", max_abs_err_A=err,
                       types_identical=same, atol_A=cs.BF16_PATH_ATOL)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if profile:
        K.PROFILE_BUILD = True
        for label in dict.fromkeys(order):
            use(label)
            for case, calls in cases.items():
                for wrapper in WRAPPERS:
                    _, args, kw = next(c for c in calls if c[0] == wrapper)
                    print(f"[cycles] {label} {case} {wrapper} bf16: "
                          + cs.describe_cycles(K, wrapper, args, kw),
                          flush=True)
        K.PROFILE_BUILD = False
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", metavar="LABEL=SOURCE")
    parser.add_argument("--order", default=None,
                        help="comma-separated labels (default: all, then "
                        "all reversed)")
    parser.add_argument("--bf16", action="store_true",
                        help="the bf16 entries on [modes] (a)'s calls")
    parser.add_argument("--path", action="store_true",
                        help="with --bf16: the fixed-noise bf16 "
                        "trajectory per build")
    parser.add_argument("--profile", action="store_true",
                        help="with --bf16: cycles per phase per build")
    parser.add_argument("--unpack", metavar="LABEL=REV", default=None,
                        help="write REV's csrc/ to build/ab/LABEL and exit")
    opts = parser.parse_args()
    if opts.unpack:
        unpack(opts.unpack)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("forward_build_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.ops import egnn_kernels as K

    sources = {"change": K.SOURCE}
    for item in opts.sources:
        label, path = item.split("=", 1)
        sources[label] = os.path.abspath(path)
    labels = list(sources)
    order = (opts.order.split(",") if opts.order
             else labels + labels[::-1])
    build = K.build_library
    t0 = time.perf_counter()
    libs = {}
    profiles = (False, True) if opts.profile else (False,)
    with ThreadPoolExecutor(len(sources) * len(profiles)) as pool:
        futures = {(k, prof): pool.submit(build, prof, type(K.SOURCE)(v))
                   for k, v in sources.items() for prof in profiles}
        for key, f in futures.items():
            try:
                libs[key] = f.result()
            except RuntimeError as e:     # a build that does not compile
                print(f"[build] {key} failed: {str(e)[:4000]}", flush=True)
    if ("change", False) not in libs:
        return 1
    order = [k for k in order if (k, False) in libs]
    print(f"[identity] {cs.nvidia_smi()}; torch {torch.__version__}; "
          f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first = None
    for label in dict.fromkeys(order):
        for kernel, report in ptxas_report(libs[(label, False)]).items():
            print(f"[ptxas] {label} {kernel}: {report}", flush=True)
        for note in ptxas_losses(libs[(label, False)]):
            print(f"[ptxas] {label} {note}", flush=True)
        if not opts.bf16:
            continue
        # HGMMA per kernel, and whether each fp32 kernel's SASS is the
        # first build's
        code = sass(libs[(label, False)])
        first = first or code
        for kernel, lines in sorted(code.items()):
            same = ("" if "_bf16" in kernel else
                    f", SASS equal to {order[0]}'s: "
                    f"{lines == first.get(kernel)}")
            print(f"[sass] {label} {kernel}: {len(lines)} instructions, "
                  f"{sum('HGMMA' in i for i in lines)} HGMMA{same}",
                  flush=True)
    packers = {k: bf16_packer(v, K.pack_w2_bf16) for k, v in sources.items()}

    def use(label):
        K._load.cache_clear()
        K._SPLIT_CACHE.clear()
        K.pack_w2_bf16 = packers[label]
        K.build_library = (
            lambda profile=False, source=K.SOURCE:
            libs[(label, profile)] if source == K.SOURCE
            else build(profile, source))

    use("change")
    ds = ProcessedLigandPocketDataset(os.path.join(cs.DATA, "test.npz"))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    if opts.bf16:
        make = v3b_maker(torch, cs)
        cases = capture_bf16(torch, K, cs, ds, make)
        path_ref = (cs.bf16_fixed_run(torch, make, ds[cs.POCKETS[0]], "cpu")
                    if opts.path else None)
        rows = bf16_rows(torch, K, cs, cases, order, use, path_ref, make,
                         ds, opts.profile)
        failed = sorted({(r["build"], r["case"], r["wrapper"]) for r in rows
                         if "wrapper" in r
                         and not r["bf16_gate_share"] <= 1.0})
        out = "forward_build_ab_bf16.jsonl"
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cases = capture(torch, K, cs, ds, tmp)
        refs = {case: [getattr(K, w + "_plain")(*a, **kw)
                       for w, a, kw in calls]
                for case, calls in cases.items()}
        rows = fp32_rows(torch, K, cs, cases, refs, order, use)
        failed = sorted({(r["build"], r["case"], r["wrapper"]) for r in rows
                         if not r["tolerance_share"] <= 1.0})
        out = "forward_build_ab.jsonl"
    with open(os.path.join(REPO, "chiprun_out", out), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(json.dumps({"over_the_gate": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
