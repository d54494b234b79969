#!/usr/bin/env python3
"""Time the generation calls that the facade's automatic band reaches, for
several copies of the port, on one NVIDIA GPU.

    python3 scripts/auto_band_ab.py [--order a,b,...] LABEL=ROOT [...]

ROOT is a directory that holds a ``diffndm_tpu_torch`` package (a
checkout, or the package unpacked from another commit); ``.`` is this
checkout.  For each label in the order given (default: every label, then
again in reverse), a fresh process imports that package, builds its
forward kernels under ROOT/build, and times, with ``DIFFNDM_AUTO_BAND``
and ``DIFFNDM_BAND_APPROX`` unset, the ``generate_ligands`` calls of two
chip_smoke.py phases on this checkout's data and weights:

- ``ca``: [configs]' CA generation, configs/crossdock_ca_cond.yml on
  seeded random weights on the synthetic receptor's CA crop, B = 16,
  T = 500;
- ``sweep_b``: the generation calls of [sweep] (b), the trained v3b
  weights on test pockets 5 and 48 written as PDB + SDF, B = 16, T = 500.

Each call runs twice: the host seconds of both (synchronised) are kept,
the first with the warm-up.  Before them the process times its one-time
costs: the CUDA context, and the kernels' library loaded and asked for
its launch grid at every width.  One JSON line per label and run, with the
``[banding]`` lines the calls printed, the window the denoiser ran and
the card's name and power limit, goes to the standard output and to
``chiprun_out/auto_band_ab.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_B_POCKETS = (5, 48)
RUNS = 2


def timed_generations(root: str) -> dict:
    """Every timed call of one process on the package under ``root``."""
    sys.path[:0] = [os.path.abspath(root), REPO]
    import numpy as np
    import torch

    import chip_smoke as cs
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.ops import egnn_kernels as K

    assert K.__file__.startswith(os.path.abspath(root)), K.__file__
    for k in ("DIFFNDM_AUTO_BAND", "DIFFNDM_BAND_APPROX"):
        os.environ.pop(k, None)
    torch.set_grad_enabled(False)
    K.build_library()
    # one-time costs of the process, apart from the first call: the CUDA
    # context, then the kernels' library loaded and asked for its grid at
    # every width (which loads each forward kernel)
    setup = {}
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    setup["context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for h in K.SUPPORTED_HIDDEN:
        for name in ("gcl_messages", "edge_vector_reduce_pair"):
            K.launch_grid(name, 1, 8, h)
    setup["library_s"] = time.perf_counter() - t0
    sample_cfg = SampleConfig(n_samples=cs.N_SAMPLES, timesteps=cs.T_MAIN)
    ds = ProcessedLigandPocketDataset(os.path.join(cs.DATA, "test.npz"))
    out = {"setup": setup}

    def run(label, model, pdb, sdf):
        for i in range(RUNS):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.generate_ligands(pdb, sdf, seed=cs.SEED)
                torch.cuda.synchronize()
            out.setdefault(label, []).append(dict(
                seconds=time.perf_counter() - t0,
                banding=[ln for ln in text.getvalue().splitlines()
                         if ln.startswith("[banding]")],
                # (None in a package without the band)
                window=getattr(model.cfg.egnn, "band_window", None),
                denoiser_window=getattr(model.dynamics.cfg, "band_window",
                                        None)))

    with tempfile.TemporaryDirectory() as tmp:
        pdb, sdf, _ = cs.joint_receptor(ds, tmp)
        run("ca", cs.seeded_model(torch, cs.CA_CONFIG, "cuda",
                                  sample_cfg=sample_cfg), pdb, sdf)
        hist = np.load(os.path.join(cs.DATA, "size_distribution.npy"))
        v3b = DiffNDM.from_yaml(os.path.join(cs.RUN, "hparams.yaml"),
                                device="cuda", size_histogram=hist,
                                sample_cfg=sample_cfg, scorer="python")
        v3b.load_params_npz(cs.WEIGHTS)
        decoder = dataset_params["crossdock_full"]["atom_decoder"]
        for idx in SWEEP_B_POCKETS:
            pdb, sdf = cs.write_pocket_files(
                ds[idx], decoder, tmp, (f"p{idx:03d}.pdb", f"p{idx:03d}.sdf"))
            run(f"sweep_b p{idx:03d}", v3b, pdb, sdf)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("builds", nargs="*", metavar="LABEL=ROOT")
    parser.add_argument("--order", default=None)
    parser.add_argument("--run", default=None, help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.run is not None:
        print(json.dumps(timed_generations(opts.run)))
        return 0
    roots = dict(b.split("=", 1) for b in opts.builds)
    if not roots:
        parser.error("name at least one LABEL=ROOT")
    order = (opts.order.split(",") if opts.order
             else list(roots) + list(roots)[::-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    path = os.path.join(REPO, "chiprun_out", "auto_band_ab.jsonl")
    with open(path, "w") as sink:
        for i, label in enumerate(order):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--run",
                 roots[label]], capture_output=True, text=True, cwd=REPO)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout + proc.stderr)
                return proc.returncode
            line = json.dumps(dict(label=label, run=i, card=smi,
                                   calls=json.loads(
                                       proc.stdout.splitlines()[-1])))
            print(line, flush=True)
            sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
