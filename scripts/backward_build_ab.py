#!/usr/bin/env python3
"""Gate and time several builds of the backward kernels on one NVIDIA GPU.

    python3 scripts/backward_build_ab.py --bf16 [--profile]
        [--order a,b,...] [LABEL=DIR ...]
    python3 scripts/backward_build_ab.py --unpack LABEL=REV

Each LABEL=DIR names another copy of ``csrc/`` (``egnn_edge.cu``,
``egnn_edge_bwd.cu`` and the ``egnn_*.cuh`` headers) with the
``egnn_kernels.py`` whose wrappers launch it beside it; the label
``change`` is the checkout's own package.  ``--unpack parent=HEAD``
writes a commit's ``csrc/`` and ``ops/egnn_kernels.py`` (from ``git
show``) to ``build/ab/parent/``, to be named as ``parent=build/ab/parent``
in a later call on the card (whose copy of the repository has no
``.git``).  All builds are compiled side by side first (with
``--profile`` also with -DEGNN_PROFILE).  Per build the script prints the
compiler's registers and spills of each backward kernel, its HGMMA
count, and whether the fp32 backward kernel's SASS (``cuobjdump -sass``)
is the first build's.

The calls are those of chip_smoke.py's [bf16train] (a): the wrapper calls
of a bf16 v3b training forward at each training shape [16, 72-96, 192]
(v3b's raw training state), of [joint-train]'s joint loss in bf16 [8,
416, 128] and at the flagship shapes [20, 344, 256].  For each build in
the order given (default: every build, then again in reverse), per group
and wrapper:

- ``--bf16``: every call's bf16 backward against the plain bf16 backward
  in float64 under chip_smoke.py's gate (``bf16_bwd_gate``, its worst
  share over the group's calls) and repeat launches bit-identical; on the
  group's first call the rounding-point shares (``rounding_share``
  against the references with and without each point) and the ms of
  both backward kernels (chip_smoke.py's ``time_ms``) beside the bound
  (``bf16_bwd_bound``) and the special-function floor
  (``bwd_sfu_floor_ms``), with the rows per block the build picks;
- always: whether the fp32 backward's gradients on every call equal the
  first build's to the bit.

``--profile`` prints where the blocks of the first bf16 and fp32
backward call at [16, 88, 192] and at the flagship spend their cycles,
per build.  One JSON line per (build, group, wrapper) goes to the
standard output and to ``chiprun_out/backward_build_ab.jsonl``
(``_bf16.jsonl`` with ``--bf16``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "diffndm_tpu_torch/csrc"
OPS = "diffndm_tpu_torch/ops/egnn_kernels.py"
WRAPPERS = ("gcl_messages", "edge_vector_reduce_pair")


def unpack(item):
    """Write REV's csrc/ files and its ops/egnn_kernels.py under
    build/ab/LABEL/ with git show."""
    label, rev = item.split("=", 1)
    dest = os.path.join(REPO, "build", "ab", label)
    os.makedirs(dest, exist_ok=True)
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{CSRC}"],
                           cwd=REPO, check=True, capture_output=True,
                           text=True).stdout.split()
    for path in [f"{CSRC}/{name}" for name in names] + [OPS]:
        data = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=REPO,
                              check=True, capture_output=True).stdout
        with open(os.path.join(dest, os.path.basename(path)), "wb") as f:
            f.write(data)
    print(f"{label}: {rev}'s {CSRC} and {OPS} in "
          f"{os.path.relpath(dest, REPO)}")


def load_kernels(label, directory):
    """The egnn_kernels module of a build: the checkout's for ``change``,
    else the copy in ``directory``, pointed at the sources beside it."""
    if label == "change":
        from diffndm_tpu_torch.ops import egnn_kernels
        return egnn_kernels
    spec = importlib.util.spec_from_file_location(
        f"egnn_kernels_{label}", os.path.join(directory, "egnn_kernels.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.SOURCE = Path(directory, "egnn_edge.cu").resolve()
    module.BWD_SOURCE = Path(directory, "egnn_edge_bwd.cu").resolve()
    # the forward's source is these functions' default argument
    for fn in (module.library_path, module.build_library):
        fn.__defaults__ = (False, module.SOURCE)
    return module


def kernel_label(mangled):
    """'gcl_messages_bwd H=192' (fp32) or '..._bwd_bf16 H=192' from a
    backward kernel's mangled name, old (edge_chain_bwd_mma<H, VEC,
    BF16>) or new (edge_chain_bwd_mma<H, VEC>, edge_chain_bwd_wgmma<H,
    VEC>); None for another function."""
    m = re.search(r"edge_chain_bwd_(w?gmma|mma)ILi(\d+)ELb([01])E"
                  r"(?:Lb([01])E)?", mangled)
    if not m:
        return None
    name = "edge_vector_reduce" if m[3] == "1" else "gcl_messages"
    bf16 = m[1] == "wgmma" or m[4] == "1"
    return f"{name}_bwd{'_bf16' if bf16 else ''} H={int(m[2])}"


def ptxas_report(so):
    out, kernel = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_label(line)
        elif kernel and ("registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.split(":")[-1].strip())
    losses = [line.split("Performance Loss: ")[1].split(" in the function")[0]
              for line in so.with_suffix(".log").read_text().splitlines()
              if "Performance Loss" in line]
    return {k: "; ".join(v) for k, v in out.items()}, losses


def sass(so):
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, kernel = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            kernel = kernel_label(line)
            if kernel:
                out[kernel] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;", line)
        if kernel and m:
            out[kernel].append(m[1])
    return out


def capture(torch, K, cs, ds, tmp):
    """{group: [(wrapper, args, kw)]}: chip_smoke.py's [bf16train] (a)
    calls, the wrappers' keyword arguments in bf16."""
    _, trainer = cs.make_trainer(torch, "cuda", compute_dtype="bfloat16")
    _, batches = cs.train_batches(torch, "cuda")
    groups = {}
    for n in cs.TRAIN_N:
        groups[str(n)] = cs.capture_train_calls(torch, K, trainer,
                                                *batches[n])
    joint = cs.with_egnn(cs.seeded_model(torch, cs.JOINT_CONFIG, "cuda"),
                         compute_dtype="bfloat16")
    pdb, sdf, _ = cs.joint_receptor(ds, tmp)
    loss_value = cs.joint_train_loss(torch, joint, ds, pdb, sdf)
    calls, recorders, originals = cs.first_forward_recorder(
        K, joint.cfg.egnn.n_layers)
    for n, f in recorders.items():
        setattr(K, n, f)
    try:
        loss_value()
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    groups["joint-train"] = calls
    groups["flagship"] = [(w, *cs.flagship_inputs(torch, w, "cuda"))
                          for w in WRAPPERS]
    return {g: [(w, a, dict(kw, compute_dtype="bfloat16"))
                for w, a, kw in calls if w in WRAPPERS]
            for g, calls in groups.items()}


def gout_for(torch, name, args, seed):
    pair = name.endswith("_pair")
    shape = (args[0][0] if pair else args[0]).shape
    return torch.randn((*shape[:2], 3 if pair else shape[2]),
                       generator=torch.Generator(device="cuda").manual_seed(
                           seed), device="cuda") * 1e-2


class Reference:
    """The plain bf16 backward of a call in float64 and in fp32, and in
    float64 without each rounding point (the first call of a group), from
    the checkout's plain functions (every build's are the same)."""

    def __init__(self, torch, K, cs, name, args, kw, gout, points):
        pair = name.endswith("_pair")
        plain = getattr(K, name.replace("_pair", "") + (
            "_pair" if pair else "") + "_backward_plain")
        detached = [tuple(t.detach() for t in a) if isinstance(a, (tuple,
                                                                   list))
                    else (a.detach() if a is not None else None)
                    for a in args]

        def run(dtype):
            cast = [tuple(t.to(dtype) for t in a) if isinstance(a, tuple)
                    else (a.to(dtype) if a is not None else None)
                    for a in detached]
            return cs.flat_grads(plain(gout.to(dtype), *cast, **kw))

        self.names = cs.leaf_names(name, args)
        self.ref64 = run(torch.float64)
        self.ref = [g.float() for g in self.ref64]
        self.sound = run(torch.float32)
        self.faults = {}
        if points:
            for point in cs.BF16_POINTS:
                with cs.dropped_rounding(K, point):
                    self.faults[point] = run(torch.float64)


def grads(torch, Kb, cs, name, args, kw, gout, dtype):
    new, leaves, _ = cs.bwd_inputs(torch, name, args)
    with torch.enable_grad():
        out = getattr(Kb, name)(*new, **dict(kw, compute_dtype=dtype))
        return torch.autograd.grad(out, leaves, gout)


def run_group(torch, Kb, cs, label, group, calls, refs, first32, bf16):
    rows = []
    for wrapper in WRAPPERS:
        mine = [(i, c) for i, c in enumerate(calls) if c[0] == wrapper]
        if not mine:
            continue
        worst, bits_ok, fp32_equal, points = 0.0, True, True, {}
        for j, (i, (_, args, kw)) in enumerate(mine):
            gout = gout_for(torch, wrapper, args, cs.SEED + j)
            got32 = grads(torch, Kb, cs, wrapper, args, kw, gout, "float32")
            key = (group, i)
            first32.setdefault(key, got32)
            fp32_equal &= all(torch.equal(a, b)
                              for a, b in zip(got32, first32[key]))
            if not bf16:
                continue
            r = refs[key]
            got = grads(torch, Kb, cs, wrapper, args, kw, gout, "bfloat16")
            again = grads(torch, Kb, cs, wrapper, args, kw, gout, "bfloat16")
            bits_ok &= all(torch.equal(a, b) for a, b in zip(got, again))
            share, ok = cs.bf16_bwd_gate(torch, Kb, got, r.ref, r.names,
                                         r.sound)
            worst = max(worst, share if ok else max(share, 1.0 + 1e-9))
            for point, fault in r.faults.items():
                points[point] = cs.rounding_share(got, r.ref64, fault,
                                                  r.names)
        _, args, kw = mine[0][1]
        gout = gout_for(torch, wrapper, args, cs.SEED)
        pair = wrapper.endswith("_pair")
        shape = list((args[0][0] if pair else args[0]).shape)
        reps = 10 if group.isdigit() else 3
        row = dict(build=label, group=group, wrapper=wrapper, shape=shape,
                   calls=len(mine), fp32_bits_equal_first_build=fp32_equal,
                   fp32_ms=cs.time_ms(torch, cs.bwd_call(
                       Kb, wrapper, args, kw, gout), reps))
        if bf16:
            bound, by = cs.bf16_bwd_bound(wrapper, args, kw)
            ms = cs.time_ms(torch, cs.bwd_call(Kb, wrapper, args, kw, gout,
                                               True), reps)
            try:
                grid = Kb.bwd_launch_grid(wrapper, *shape, kw.get("n_rows"),
                                          "bfloat16")
            except TypeError:         # a build without the dtype argument
                grid = Kb.bwd_launch_grid(wrapper, *shape, kw.get("n_rows"))
            row.update(ms=ms, bound_ms=bound, bound_by=by,
                       bound_share=bound / ms,
                       sfu_floor_ms=cs.bwd_sfu_floor_ms(torch, wrapper,
                                                        args, kw),
                       gate_share=worst, repeat_bits_equal=bits_ok,
                       rounding_shares=points, blocks=grid[0],
                       rows_per_block=grid[1])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", metavar="LABEL=DIR")
    parser.add_argument("--order", default=None,
                        help="comma-separated labels (default: all, then "
                        "all reversed)")
    parser.add_argument("--bf16", action="store_true",
                        help="gate, rounding points and times of the bf16 "
                        "backward")
    parser.add_argument("--profile", action="store_true",
                        help="cycles per phase per build")
    parser.add_argument("--unpack", metavar="LABEL=REV", default=None,
                        help="write REV's csrc/ and ops module to "
                        "build/ab/LABEL and exit")
    opts = parser.parse_args()
    if opts.unpack:
        unpack(opts.unpack)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("backward_build_ab: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset

    dirs = {"change": None}
    for item in opts.sources:
        label, path = item.split("=", 1)
        dirs[label] = os.path.abspath(path)
    labels = list(dirs)
    order = opts.order.split(",") if opts.order else labels + labels[::-1]
    mods = {k: load_kernels(k, v) for k, v in dirs.items()}
    t0 = time.perf_counter()
    profiles = (False, True) if opts.profile else (False,)
    libs = {}
    with ThreadPoolExecutor(2 * len(mods) * len(profiles)) as pool:
        # one build per library (two copies of a source share one)
        by_path = {}
        futures = {}
        for k, m in mods.items():
            for src in ("SOURCE", "BWD_SOURCE"):
                for prof in profiles:
                    path = m.library_path(prof, getattr(m, src))
                    if path not in by_path:
                        by_path[path] = pool.submit(m.build_library, prof,
                                                    getattr(m, src))
                    futures[k, src, prof] = by_path[path]
        for key, f in futures.items():
            try:
                libs[key] = f.result()
            except RuntimeError as e:     # a build that does not compile
                print(f"[build] {key} failed: {str(e)[:4000]}", flush=True)
    if any(k not in libs for k in futures):
        return 1
    print(f"[identity] {cs.nvidia_smi()}; torch {torch.__version__}; "
          f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first = None
    for label in dict.fromkeys(order):
        so = libs[(label, "BWD_SOURCE", False)]
        report, losses = ptxas_report(so)
        for kernel, text in sorted(report.items()):
            print(f"[ptxas] {label} {kernel}: {text}", flush=True)
        for note in sorted(set(losses)):
            print(f"[ptxas] {label} Performance Loss: {note}", flush=True)
        code = sass(so)
        first = first or code
        for kernel, lines in sorted(code.items()):
            same = ("" if "_bf16" in kernel else
                    f", SASS equal to {order[0]}'s: "
                    f"{lines == first.get(kernel)}")
            print(f"[sass] {label} {kernel}: {len(lines)} instructions, "
                  f"{sum('HGMMA' in i for i in lines)} HGMMA{same}",
                  flush=True)
    K = mods["change"]
    ds = ProcessedLigandPocketDataset(os.path.join(cs.DATA, "test.npz"))
    with tempfile.TemporaryDirectory() as tmp:
        groups = capture(torch, K, cs, ds, tmp)
    t1 = time.perf_counter()
    refs = {}
    if opts.bf16:
        for group, calls in groups.items():
            seen = set()
            for i, (name, args, kw) in enumerate(calls):
                j = sum(1 for c in calls[:i] if c[0] == name)
                refs[group, i] = Reference(
                    torch, K, cs, name, args, kw,
                    gout_for(torch, name, args, cs.SEED + j),
                    name not in seen)
                seen.add(name)
    print(f"[refs] {sum(len(c) for c in groups.values())} calls in "
          f"{len(groups)} groups, references in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    rows, first32 = [], {}
    for label in order:
        for group, calls in groups.items():
            rows += run_group(torch, mods[label], cs, label, group, calls,
                              refs, first32, opts.bf16)
    if opts.profile:
        for label in dict.fromkeys(order):
            Kb = mods[label]
            Kb.PROFILE_BUILD = True
            for group in ("88", "flagship"):
                for wrapper in WRAPPERS:
                    _, args, kw = next(c for c in groups[group]
                                       if c[0] == wrapper)
                    gout = gout_for(torch, wrapper, args, cs.SEED)
                    shape = list((args[0][0] if wrapper.endswith("_pair")
                                  else args[0]).shape)
                    for bf16 in (False, True):
                        # an older build's bf16 kernel counts the fp32
                        # kernel's spans
                        new_fields = "chain" in Kb.PROFILE_BWD_FIELDS
                        print(f"[cycles] {label} {group} {wrapper} "
                              f"{'bf16' if bf16 else 'fp32'} {shape}: "
                              + cs.describe_bwd_cycles(
                                  torch, Kb, cs.bwd_call(Kb, wrapper, args,
                                                         kw, gout, bf16),
                                  bf16 and new_fields), flush=True)
            Kb.PROFILE_BUILD = False
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    out = "backward_build_ab" + ("_bf16" if opts.bf16 else "") + ".jsonl"
    with open(os.path.join(REPO, "chiprun_out", out), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    failed = sorted({(r["build"], r["group"], r["wrapper"]) for r in rows
                     if not r["fp32_bits_equal_first_build"]
                     or (opts.bf16 and not (r["gate_share"] <= 1.0
                                            and r["repeat_bits_equal"]))})
    print(json.dumps({"failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
