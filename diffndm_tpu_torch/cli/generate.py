"""Conditional ligand generation from a PDB pocket (the reference's
generate_ligands.py), on the GPU unless ``--device cpu``.

Example:
    python -m diffndm_tpu_torch.cli.generate \
        diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz \
        --config examples/checkpoints/virtual_cond_v3b/hparams.yaml \
        --pdbfile pocket.pdb --ref_ligand A:330 --outfile out.sdf \
        --n_samples 20 --SPSA 1 --SVDD 1

The checkpoint is a flat ``.npz`` of the JAX package's parameter tree
(README "PyTorch port (H100)" has the one-line export from an orbax
checkpoint), or the reference implementation's ``.ckpt``; a path that
does not exist gives a warning and random weights.  ``--optimize 1``
adjusts every step with the RL AdjustNet (``--path`` loads it);
``--path_save`` trains it by REINFORCE after each of ``--rl_loops``
generations and saves it there (an ``.npz`` the JAX package reads too).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("checkpoint", type=str,
                   help="npz of the JAX parameter tree or reference .ckpt")
    p.add_argument("--pdbfile", type=str, required=True)
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--ref_ligand", type=str, default=None,
                   help="SDF path or <chain>:<resi>")
    p.add_argument("--n_samples", type=int, default=20)
    p.add_argument("--num_nodes_lig", type=int, default=None)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--all_frags", action="store_true")
    p.add_argument("--sanitize", action="store_true")
    p.add_argument("--relax", action="store_true")
    p.add_argument("--resamplings", type=int, default=1)
    p.add_argument("--config", type=str, default=None,
                   help="model YAML (defaults to built-in fullatom cond)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--optimize", type=int, default=0)
    p.add_argument("--path", type=str, default=None,
                   help="AdjustNet checkpoint to load")
    p.add_argument("--path_save", type=str, default=None,
                   help="AdjustNet checkpoint to save after RL update")
    p.add_argument("--SVDD", type=int, default=0)
    p.add_argument("--SPSA", type=int, default=0)
    p.add_argument("--noise_scale", type=float, default=1.0,
                   help="scale on the noise injected at each reverse step "
                        "(1.0 = the model's own; < 1 trades diversity for "
                        "typicality)")
    p.add_argument("--w_connectivity", type=float, default=0.0,
                   help="guidance-reward weight on the largest-fragment "
                        "fraction")
    p.add_argument("--w_vina", type=float, default=0.0,
                   help="affinity term of the guidance rewards: reward += "
                        "w_vina * (-Vina-style score) against --pdbfile "
                        "(scored row by row in this process)")
    p.add_argument("--rl_loops", type=int, default=1,
                   help="repeat generation + REINFORCE this many times "
                        "(with --path_save)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain "
                        "versions")
    return p


def load_model(args):
    from diffndm_tpu_torch.config import (ATPConfig, ModelConfig, RLConfig,
                                          SampleConfig, SPSAConfig)
    from diffndm_tpu_torch.device import resolve_device
    from diffndm_tpu_torch.model import DiffNDM

    device = resolve_device(args.device)
    # pockets batched together (the sweep's --batch_pockets) must not
    # select ATP candidates across pockets: a prune selects within each
    # pocket's n_samples rows
    group_size = (args.n_samples if getattr(args, "batch_pockets", 1) > 1
                  else None)
    sample_cfg = SampleConfig(
        n_samples=args.n_samples, timesteps=args.timesteps,
        sanitize=args.sanitize, relax_iter=(200 if args.relax else 0),
        # the largest fragment is kept unless --all_frags, with or without
        # --sanitize, as the reference does
        largest_frag=not args.all_frags, noise_scale=args.noise_scale,
        spsa=SPSAConfig(enabled=bool(args.SPSA), w_vina=args.w_vina,
                        w_connectivity=args.w_connectivity),
        atp=ATPConfig(enabled=bool(args.SVDD), group_size=group_size,
                      w_vina=args.w_vina,
                      w_connectivity=args.w_connectivity),
        rl=RLConfig(enabled=bool(args.optimize),
                    train=bool(args.path_save)))
    ckpt = Path(args.checkpoint)
    if ckpt.is_dir():
        raise ValueError(
            f"{ckpt} is a directory (an orbax checkpoint?): this package "
            "reads no orbax; export it to an .npz with the one-liner in "
            "README \"PyTorch port (H100)\"")
    if ckpt.exists() and ckpt.suffix not in (".npz", ".ckpt"):
        raise ValueError(f"{ckpt}: expected an .npz of the JAX parameter "
                         "tree or a reference .ckpt")
    # the random initialisation (missing checkpoint) follows --seed
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        if args.config:
            model = DiffNDM.from_yaml(args.config, sample_cfg=sample_cfg,
                                      device=device)
        else:
            model = DiffNDM(ModelConfig(), sample_cfg=sample_cfg,
                            device=device)
    if ckpt.suffix == ".ckpt" and ckpt.exists():
        model.load_reference_checkpoint(str(ckpt))
    elif ckpt.exists():
        model.load_params_npz(str(ckpt))
    else:
        print(f"[warn] checkpoint {ckpt} not found - using random init")
    if args.optimize or args.path:
        adj = model.ensure_adjust()
        if args.path:
            adj.load(args.path)
    if args.w_vina > 0 and getattr(args, "pdbfile", None):
        model.ensure_oracle().set_receptor(args.pdbfile)
    return model


def main(argv=None):
    """Run the CLI; returns the model (its ``adjust_state.history`` holds
    the REINFORCE updates)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.ref_ligand is None:
        parser.error("--ref_ligand (an SDF path or <chain>:<resi>) is "
                     "required to find the pocket")
    from diffndm_tpu_torch.chem.io import write_sdf

    model = load_model(args)
    num_nodes = (np.full((args.n_samples,), args.num_nodes_lig)
                 if args.num_nodes_lig else None)
    loops = max(1, args.rl_loops if args.path_save else 1)
    with model:                     # releases the oracle's workers
        for loop in range(loops):
            t0 = time.perf_counter()
            mols, _ = model.generate_ligands(args.pdbfile, args.ref_ligand,
                                             seed=args.seed + loop,
                                             num_nodes_lig=num_nodes)
            seconds = time.perf_counter() - t0
            if args.path_save:
                model.adjust_state.save(args.path_save)
                loss, grad_norm, reward = model.adjust_state.history[-1]
                print(f"[loop {loop}] {seconds:.3f} s; REINFORCE loss "
                      f"{loss:.6g}, grad norm {grad_norm:.6g}, reward "
                      f"{reward:.6g}; saved AdjustNet checkpoint to "
                      f"{args.path_save}")
    write_sdf(args.outfile, mols)
    n_ok = sum(m is not None for m in mols)
    print(f"wrote {n_ok}/{len(mols)} molecules to {args.outfile}")
    return model


if __name__ == "__main__":
    main()
