#!/usr/bin/env python3
"""Gate and time several builds of the forward kernels on one NVIDIA GPU.

    python3 scripts/forward_build_ab.py [--order a,b,...] [LABEL=SOURCE ...]

Each LABEL=SOURCE names another copy of ``csrc/egnn_edge.cu`` (with its
``egnn_mma.cuh`` beside it); the label ``change`` is the checkout's own
source.  All builds are compiled side by side first.  The script then
captures, through the checkout's build, the kernel calls of real first
denoiser forwards at full width on seeded random weights (chip_smoke.py's
``seeded_model``):

- ``<config> joint``: the joint sampler's first forward (t = T, joint
  noise, 16 rows at sizes of the size prior, every row moving) of each
  joint config;
- ``<config> cond``: the conditional sampler's first state of
  virtual_cond (H = 128), virtual_cond_v3b (H = 192) and
  crossdock_fullatom_cond (H = 256), 16 rows on test pocket 220 written as
  PDB + SDF.

For each build in the order given (default: every build, then again in
reverse), it runs every captured call of both wrappers: the largest share
of the gate atol 1e-5 + rtol 1e-4 against the plain version that any
output element uses (over 1 fails chip_smoke.py), and the device ms of the
case's first call (chip_smoke.py's ``time_ms``).  One JSON line per
(build, case, wrapper) goes to the standard output and to
``chiprun_out/forward_build_ab.jsonl``, after the compiler's register and
spill report of each build.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COND_CASES = ("virtual_cond", "virtual_cond_v3b", "crossdock_fullatom_cond")
B = 16


def ptxas_report(so):
    """{'gcl_messages H=128': 'Used 230 registers, ...; 0 bytes spill
    stores, ...'} from the build's compiler log."""
    out, kernel = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_mmaILi(\d+)"
                      r"ELb([01])E(?:Lb([01])E)?", line)
        if m:
            name = "edge_vector_reduce" if m[2] == "1" else "gcl_messages"
            kernel = f"{name}{'_bf16' if m[3] == '1' else ''} H={int(m[1])}"
        elif kernel and ("registers" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.split(":")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


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


def share(out, ref, cs):
    return float(((out - ref).abs()
                  / (cs.KERNEL_ATOL + cs.KERNEL_RTOL * ref.abs())).max())


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="*", metavar="LABEL=SOURCE")
    parser.add_argument("--order", default=None,
                        help="comma-separated labels (default: all, then "
                        "all reversed)")
    opts = parser.parse_args()
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
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {k: pool.submit(build, False, type(K.SOURCE)(v))
                   for k, v in sources.items()}
        for k, f in futures.items():
            try:
                libs[k] = f.result()
            except RuntimeError as e:     # a build that does not compile
                print(f"[build] {k} failed: {str(e)[:2000]}", flush=True)
    if "change" not in libs:
        return 1
    order = [k for k in order if k in libs]
    print(f"[identity] {cs.nvidia_smi()}; torch {torch.__version__}; "
          f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for label, so in libs.items():
        for kernel, report in ptxas_report(so).items():
            print(f"[ptxas] {label} {kernel}: {report}", flush=True)

    def use(label):
        K._load.cache_clear()
        K.build_library = (lambda profile=False, source=K.SOURCE:
                           libs[label] if source == K.SOURCE
                           else build(profile, source))

    use("change")
    ds = ProcessedLigandPocketDataset(os.path.join(cs.DATA, "test.npz"))
    with tempfile.TemporaryDirectory() as tmp:
        cases = capture(torch, K, cs, ds, tmp)
    refs = {case: [getattr(K, w + "_plain")(*a, **kw) for w, a, kw in calls]
            for case, calls in cases.items()}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    rows = []
    for label in order:
        use(label)
        for case, calls in cases.items():
            for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
                mine = [(c, r) for c, r in zip(calls, refs[case])
                        if c[0] == wrapper]
                fn = getattr(K, wrapper)
                worst = max(share(fn(*a, **kw), r, cs)
                            for (_, a, kw), r in mine)
                _, args, kw = mine[0][0]
                row = dict(build=label, case=case, wrapper=wrapper,
                           shape=list((args[0][0] if wrapper.endswith("_pair")
                                       else args[0]).shape),
                           calls=len(mine), tolerance_share=worst,
                           ms=cs.time_ms(torch, lambda: fn(*args, **kw), 20),
                           bound_ms=cs.bound_ms(*cs.call_cost(wrapper, args,
                                                              kw))[0])
                rows.append(row)
                print(json.dumps(row), flush=True)
    with open(os.path.join(REPO, "chiprun_out", "forward_build_ab.jsonl"),
              "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    failed = sorted({(r["build"], r["case"], r["wrapper"]) for r in rows
                     if not r["tolerance_share"] <= 1.0})
    print(json.dumps({"over_the_gate": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
