"""Fragment-constrained generation by RePaint inpainting (the reference's
inpaint.py), on the GPU unless ``--device cpu``.

Example:
    python -m diffndm_tpu_torch.cli.inpaint \
        diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz \
        --config examples/checkpoints/virtual_cond_v3b/hparams.yaml \
        --pdbfile pocket.pdb --outfile out.sdf --fix_atoms frag.sdf \
        --add_n_nodes 10 --n_samples 16 --timesteps 60 --resamplings 10 \
        --svdd 1

The fixed atoms come from SDF file(s) (``cli.fix_ligand`` makes one from
a ligand) or are PDB atom names of the ``--ref_ligand <chain>:<resi>``
residue of ``--pdbfile``.  Each sample has the fixed atoms first, then
``--add_n_nodes`` new ones.  The molecules are written whole (no
largest-fragment extraction), sanitized with ``--sanitize``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=str)
    p.add_argument("--pdbfile", type=str, required=True)
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--ref_ligand", type=str, default=None)
    p.add_argument("--fix_atoms", type=str, nargs="+", required=True,
                   help="SDF file(s) with the fixed substructure, or PDB "
                        "atom names (e.g. C1 C2 N3) of the --ref_ligand "
                        "residue of --pdbfile")
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--add_n_nodes", type=int, default=10)
    p.add_argument("--center", type=str, default="ligand",
                   choices=("ligand", "pocket"))
    p.add_argument("--timesteps", type=int, default=50)
    p.add_argument("--resamplings", type=int, default=20)
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--svdd", type=int, default=0)
    p.add_argument("--spsa", type=int, default=0)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise_scale", type=float, default=1.0,
                   help="scale on the noise injected at each reverse step "
                        "(see cli.generate)")
    p.add_argument("--w_connectivity", type=float, default=0.0,
                   help="guidance-reward weight on the largest-fragment "
                        "fraction")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain "
                        "versions")
    return p


def substructure_coords_types(model, fix_atoms, pdbfile=None,
                              ref_ligand=None):
    """The fixed substructure's coordinates [n, 3] (float32) and type
    indices [n]: the atoms of the first record of each SDF file, or the
    atoms with the given names in the ``<chain>:<resi>`` residue; atoms
    of elements the model has no type for are left out."""
    enc = {k: v for k, v in model.dataset_info["atom_encoder"].items()
           if v < model.cfg.atom_nf}
    if isinstance(fix_atoms, str):
        fix_atoms = [fix_atoms]
    if fix_atoms[0].endswith(".sdf"):
        from diffndm_tpu_torch.chem.io import read_sdf

        coords, types = [], []
        for path in fix_atoms:
            frag = read_sdf(path)[0]
            for i, s in enumerate(frag.symbols):
                if s in enc:
                    coords.append(np.asarray(frag.coords)[i])
                    types.append(enc[s])
        return np.asarray(coords, np.float32), np.asarray(types)

    from diffndm_tpu_torch.data.pdb import parse_pdb

    if pdbfile is None or ref_ligand is None:
        raise ValueError("--fix_atoms with atom names needs --pdbfile "
                         "and --ref_ligand <chain>:<resi>")
    chain, resi = ref_ligand.split(":")
    residue = next((res for res in parse_pdb(pdbfile).residues
                    if res.chain == chain and res.resi == int(resi)), None)
    if residue is None:
        raise ValueError(f"residue {ref_ligand} not found in {pdbfile}")
    wanted = set(fix_atoms)
    coords, types = [], []
    for a in residue.atoms:
        if a.name in wanted and a.element in enc:
            coords.append(a.coord)
            types.append(enc[a.element])
    if not coords:
        raise ValueError(f"no atoms named {sorted(wanted)} in {ref_ligand}")
    return np.asarray(coords, np.float32), np.asarray(types)


def prepare_inpaint_ligand(model, fix_atoms, n_samples: int,
                           add_n_nodes: int, pdbfile=None, ref_ligand=None):
    """The input ligand batch [n_samples, NL] (the fixed atoms first, then
    add_n_nodes unset ones, NL rounded up to ``lig_pad_multiple``) and its
    fixed mask [n_samples, NL], on the CPU."""
    from diffndm_tpu_torch.structs import NodeBatch, pad_to

    coords, types = substructure_coords_types(model, fix_atoms, pdbfile,
                                              ref_ligand)
    n_fixed = len(coords)
    n_total = n_fixed + add_n_nodes
    nl = pad_to(n_total, model.sample_cfg.lig_pad_multiple)
    nf = model.cfg.atom_nf
    x = np.zeros((n_samples, nl, 3), np.float32)
    h = np.zeros((n_samples, nl, nf), np.float32)
    mask = np.zeros((n_samples, nl), np.float32)
    fixed = np.zeros((n_samples, nl), np.float32)
    x[:, :n_fixed] = coords[None]
    h[:, :n_fixed] = np.eye(nf, dtype=np.float32)[types][None]
    mask[:, :n_total] = 1.0
    fixed[:, :n_fixed] = 1.0
    return (NodeBatch(torch.from_numpy(x), torch.from_numpy(h),
                      torch.from_numpy(mask)), torch.from_numpy(fixed))


def main(argv=None):
    """Run the CLI; returns the ``SampleResult``."""
    args = build_parser().parse_args(argv)
    from diffndm_tpu_torch.chem.io import write_sdf
    from diffndm_tpu_torch.cli.generate import load_model

    # the generate CLI's settings that inpainting fixes: no AdjustNet, the
    # guidance switches passed on, whole molecules
    model = load_model(argparse.Namespace(
        **vars(args), optimize=0, path=None, path_save=None,
        SVDD=args.svdd, SPSA=args.spsa, all_frags=True, relax=False,
        w_vina=0.0))
    ligand, lig_fixed = prepare_inpaint_ligand(
        model, args.fix_atoms, args.n_samples, args.add_n_nodes,
        pdbfile=args.pdbfile, ref_ligand=args.ref_ligand)
    if args.fix_atoms[0].endswith(".sdf"):
        ref = args.ref_ligand or args.fix_atoms[0]
    else:
        ref = args.ref_ligand       # <chain>:<resi> of the reference ligand
    pocket = model.pocket_from_pdb(args.pdbfile, ref, args.n_samples)

    t0 = time.perf_counter()
    with model:                     # releases the oracle's workers
        res = model.inpaint(ligand, lig_fixed, pocket, seed=args.seed,
                            timesteps=args.timesteps,
                            resamplings=args.resamplings,
                            svdd=bool(args.svdd), spsa=bool(args.spsa),
                            center=args.center)
    mols = model.result_to_molecules(res)
    seconds = time.perf_counter() - t0
    write_sdf(args.outfile, mols)
    n_ok = sum(m is not None for m in mols)
    print(f"wrote {n_ok}/{len(mols)} molecules to {args.outfile} "
          f"({seconds:.3f} s)")
    return res


if __name__ == "__main__":
    main()
