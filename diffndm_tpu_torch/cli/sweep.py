"""Test-set sweep: generate for many pockets in one process (the
reference spawns one process per pocket: my_test.py, my_test_inpaint.py),
on the GPU unless ``--device cpu``.

Example:
    python -m diffndm_tpu_torch.cli.sweep \
        diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz \
        --config examples/checkpoints/virtual_cond_v3b/hparams.yaml \
        --test_dir pockets/ --outdir sweep_out/ --n_samples 16 \
        --batch_pockets 4

``--test_dir`` holds ``<name>.pdb`` + ``<name>.sdf`` pairs (the SDF is
the reference ligand that locates the pocket).  Three modes:

- per pocket (the default): ``<name>_gen.sdf``, generated until
  ``--n_samples`` valid molecules, at most ``--oversample_maxiter``
  generations per attempt and ``--max_tries`` attempts;
- ``--batch_pockets k``: k pockets in one batch of k * n_samples rows,
  one ``<name>_gen.sdf`` each; with ``--SVDD`` a prune selects within
  each pocket's rows;
- ``--inpaint``: the first ``--frag_fraction`` of each reference ligand
  fixed and ``--add_n_nodes`` atoms added, T = ``--timesteps`` (60) x
  ``--resamplings``; ``<name>_inpaint.sdf``.

``--resume`` skips pockets whose output exists.  ``pocket_times.txt``
records the seconds per pocket (per batch with ``--batch_pockets``).

Seeds: torch cannot replay the JAX package's key splits, so generation
number k of the sweep (counted from 0, advancing where the JAX sweep
splits its key) takes seed ``--seed + k``.  Errors of the data
(``ValueError``, which includes a failed sanitization, ``KeyError``,
``IndexError``, ``OSError``) skip a pocket or, per pocket, count a retry;
any other error (a kernel's ``RuntimeError``, a CUDA error) stops the
sweep.  The closing line counts written, resumed and skipped pockets and
retries.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

# what a pocket's data can raise; anything else is a fault of the program
DATA_ERRORS = (ValueError, KeyError, IndexError, OSError)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=str)
    p.add_argument("--test_dir", type=str, required=True,
                   help="dir of <name>.pdb + <name>.sdf pairs")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--max_pockets", type=int, default=100)
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--all_frags", action="store_true",
                   help="keep all fragments (the reference keeps the "
                        "largest)")
    p.add_argument("--oversample_maxiter", type=int, default=10,
                   help="regenerate until n_samples valid")
    p.add_argument("--max_tries", type=int, default=10)
    p.add_argument("--SVDD", type=int, default=0)
    p.add_argument("--SPSA", type=int, default=0)
    p.add_argument("--batch_pockets", type=int, default=1,
                   help="pockets generated together in one device batch "
                        "(with --SVDD the ATP top-k is restricted to each "
                        "pocket's rows)")
    p.add_argument("--inpaint", action="store_true",
                   help="inpainting sweep: fragments extracted from each "
                        "reference ligand (first 1/4 of atoms)")
    p.add_argument("--add_n_nodes", type=int, default=10)
    p.add_argument("--resamplings", type=int, default=10)
    p.add_argument("--frag_fraction", type=float, default=0.25)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_scale", type=float, default=1.0,
                   help="low-temperature sampling (see cli.generate)")
    p.add_argument("--w_connectivity", type=float, default=0.0,
                   help="connectivity guidance-reward weight (see "
                        "cli.generate)")
    p.add_argument("--resume", action="store_true",
                   help="skip pockets whose output SDF already exists")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain "
                        "versions")
    return p


def find_sdf(test_dir: str, name: str):
    """``<name>.sdf``, else the first SDF whose name starts with name."""
    sdf = os.path.join(test_dir, name + ".sdf")
    if os.path.exists(sdf):
        return sdf
    cands = [f for f in os.listdir(test_dir)
             if f.startswith(name) and f.endswith(".sdf")]
    return os.path.join(test_dir, cands[0]) if cands else None


class Sweep:
    """One sweep's model, seeds and counts."""

    def __init__(self, args, model):
        self.args, self.model = args, model
        self.generations = 0
        self.written, self.resumed, self.skipped, self.retries = 0, 0, 0, 0

    def next_seed(self) -> int:
        self.generations += 1
        return self.args.seed + self.generations - 1

    def pockets(self, suffix: str):
        """(name, PDB path, SDF path) of every pocket to run: those with
        no SDF are skipped, those with an output are resumed."""
        a = self.args
        pdbs = sorted(f for f in os.listdir(a.test_dir)
                      if f.endswith(".pdb"))[:a.max_pockets]
        for pdb in pdbs:
            name = pdb[:-4]
            sdf = find_sdf(a.test_dir, name)
            if sdf is None:
                print(f"[skip] {name}: no reference ligand SDF")
                self.skipped += 1
            elif a.resume and os.path.exists(self.out(name, suffix)):
                print(f"{name}: skipped (resume)")
                self.resumed += 1
            else:
                yield name, os.path.join(a.test_dir, pdb), sdf

    def out(self, name: str, suffix: str) -> str:
        return os.path.join(self.args.outdir, f"{name}_{suffix}.sdf")

    def write(self, name: str, suffix: str, mols) -> None:
        from diffndm_tpu_torch.chem.io import write_sdf

        write_sdf(self.out(name, suffix), mols)
        self.written += 1

    def inpaint(self):
        from diffndm_tpu_torch.chem.io import read_sdf, write_sdf
        from diffndm_tpu_torch.cli.fix_ligand import extract_fragment
        from diffndm_tpu_torch.cli.inpaint import prepare_inpaint_ligand

        a, model = self.args, self.model
        lines = []
        for name, pdb, sdf in self.pockets("inpaint"):
            t0 = time.time()
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    frag = os.path.join(tmp, "fragment.sdf")
                    write_sdf(frag, [extract_fragment(read_sdf(sdf)[0],
                                                      a.frag_fraction)])
                    ligand, lig_fixed = prepare_inpaint_ligand(
                        model, frag, a.n_samples, a.add_n_nodes)
                pocket = model.pocket_from_pdb(pdb, sdf, a.n_samples)
                res = model.inpaint(ligand, lig_fixed, pocket,
                                    seed=self.next_seed(),
                                    timesteps=a.timesteps or 60,
                                    resamplings=a.resamplings,
                                    svdd=bool(a.SVDD), spsa=bool(a.SPSA))
                mols = model.result_to_molecules(res)
            except DATA_ERRORS as e:
                print(f"[skip] {name}: {e}")
                self.skipped += 1
                continue
            self.write(name, "inpaint", [m for m in mols if m is not None])
            dt = time.time() - t0
            lines.append(f"{dt:.2f}")
            print(f"{name}: inpainted {len(mols)} in {dt:.1f}s")
        return lines

    def batches(self):
        a, model = self.args, self.model
        group = [(pdb, sdf) for _, pdb, sdf in self.pockets("gen")]
        lines = []
        for i in range(0, len(group), a.batch_pockets):
            chunk = group[i:i + a.batch_pockets]
            t0 = time.time()
            out = model.generate_ligands_multi(chunk, seed=self.next_seed())
            dt = time.time() - t0
            for pdb_name, mols in out.items():
                self.write(pdb_name[:-4], "gen",
                           [m for m in mols if m is not None])
            print(f"batch of {len(chunk)} pockets in {dt:.1f}s "
                  f"({dt / (len(chunk) * a.n_samples):.2f} s/mol)")
            lines.append(f"batch {dt:.2f}")
        return lines

    def per_pocket(self):
        from diffndm_tpu_torch.chem.sanitize import is_valid

        a, model = self.args, self.model
        lines, times = [], []
        for name, pdb, sdf in self.pockets("gen"):
            t0 = time.time()
            valid_mols = []
            for attempt in range(a.max_tries):
                try:
                    for _ in range(a.oversample_maxiter):
                        mols, _ = model.generate_ligands(
                            pdb, sdf, seed=self.next_seed())
                        valid_mols += [m for m in mols
                                       if m is not None and is_valid(m)]
                        if len(valid_mols) >= a.n_samples:
                            break
                    break
                except DATA_ERRORS as e:
                    print(f"[retry {attempt}] {name}: {e}")
                    self.retries += 1
            else:
                self.skipped += 1       # every attempt failed
            dt = time.time() - t0
            times.append(dt)
            lines.append(f"{os.path.basename(pdb)} {dt:.2f}")
            self.write(name, "gen", valid_mols[:a.n_samples])
            print(f"{name}: {len(valid_mols)} valid in {dt:.1f}s "
                  f"({dt / max(len(valid_mols), 1):.2f} s/mol)")
        if times:
            lines.append(f"mean {sum(times) / len(times):.2f}")
        return lines

    def summary(self) -> dict:
        return dict(written=self.written, resumed=self.resumed,
                    skipped=self.skipped, retries=self.retries,
                    generations=self.generations)


def main(argv=None):
    """Run the sweep; returns its counts (``Sweep.summary``)."""
    args = build_parser().parse_args(argv)
    from diffndm_tpu_torch.cli.generate import load_model

    # the generate CLI's settings the sweep fixes: no AdjustNet, no
    # relaxation, no affinity term; inpainting keeps whole molecules
    model = load_model(argparse.Namespace(**dict(
        vars(args), optimize=0, path=None, path_save=None, relax=False,
        w_vina=0.0, all_frags=args.all_frags or args.inpaint)))
    os.makedirs(args.outdir, exist_ok=True)
    sweep = Sweep(args, model)
    t0 = time.time()
    with model:                     # releases the oracle's workers
        if args.inpaint:
            lines = sweep.inpaint()
        elif args.batch_pockets > 1:
            lines = sweep.batches()
        else:
            lines = sweep.per_pocket()
    with open(os.path.join(args.outdir, "pocket_times.txt"), "w") as f:
        f.writelines(line + "\n" for line in lines)
    out = sweep.summary()
    print(f"sweep: {out['written']} pockets written, {out['resumed']} "
          f"resumed, {out['skipped']} skipped, {out['retries']} retries, "
          f"{out['generations']} generations in {time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
