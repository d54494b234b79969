"""Evolutionary ligand optimization (the reference's optimize.py), on the
GPU unless ``--device cpu``.

Example:
    python -m diffndm_tpu_torch.cli.optimize \
        diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz \
        --config examples/checkpoints/virtual_cond_v3b/hparams.yaml \
        --pdbfile pocket.pdb --ref_ligand start.sdf --outfile best.sdf \
        --objective qed --population_size 100 --evolution_steps 10

A population of copies of the starting ligand evolves: each generation
diversifies every member (noised ``--timesteps`` steps and denoised back),
scores the sanitized largest fragments by QED or SA (0 where one does
not sanitize) or by ``vina``, the negated Vina-style affinity against the
``--pdbfile`` receptor (chem/scoring.py; -inf where one does not
sanitize), and tiles the ``--top_k`` best back up to the population
size.  The last generation's top-k are written.
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
    p.add_argument("--ref_ligand", type=str, required=True,
                   help="SDF with the starting ligand (also the pocket "
                        "reference)")
    p.add_argument("--outfile", type=str, required=True)
    p.add_argument("--objective", type=str, default="qed",
                   choices=("qed", "sa", "vina"),
                   help="qed, sa, or vina: the negated Vina-style "
                        "affinity against the --pdbfile receptor "
                        "(lower is better, so evolution maximises its "
                        "negation)")
    p.add_argument("--population_size", type=int, default=100)
    p.add_argument("--evolution_steps", type=int, default=10)
    p.add_argument("--top_k", type=int, default=7)
    p.add_argument("--timesteps", type=int, default=100,
                   help="noising steps per diversification")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain "
                        "versions")
    return p


def main(argv=None):
    """Run the CLI; returns one dict per generation (best and mean score,
    seconds)."""
    args = build_parser().parse_args(argv)
    from diffndm_tpu_torch.chem.io import read_sdf, write_sdf
    from diffndm_tpu_torch.chem.metrics import MoleculeProperties
    from diffndm_tpu_torch.cli.generate import load_model
    from diffndm_tpu_torch.data.pocket import ligand_node_batch
    from diffndm_tpu_torch.structs import NodeBatch, repeat_batch

    pop = args.population_size
    # the generate CLI's settings: no guidance, no AdjustNet; the
    # sanitized largest fragment of each member is scored
    model = load_model(argparse.Namespace(
        checkpoint=args.checkpoint, config=args.config, seed=args.seed,
        device=args.device, n_samples=pop, timesteps=None, sanitize=True,
        relax=False, all_frags=False, noise_scale=1.0, SPSA=0, SVDD=0,
        w_vina=0.0, w_connectivity=0.0, optimize=0, path=None,
        path_save=None))
    props = MoleculeProperties()
    if args.objective == "vina":
        from diffndm_tpu_torch.chem.scoring import VinaScorer

        receptor = VinaScorer.from_pdb(args.pdbfile)

        def score_fn(mol):
            return -receptor.score(mol)
    else:
        score_fn = (props.calculate_qed if args.objective == "qed"
                    else props.calculate_sa)
    # a molecule that does not sanitize: 0 floors qed / sa (in [0, 1]) but
    # not vina, where a clashing valid pose scores below 0
    invalid = 0.0 if args.objective in ("qed", "sa") else -np.inf

    mol0 = read_sdf(args.ref_ligand)[0]
    enc = {k: v for k, v in model.dataset_info["atom_encoder"].items()
           if v < model.cfg.atom_nf}
    keep = [i for i, s in enumerate(mol0.symbols) if s in enc]
    ligand = repeat_batch(ligand_node_batch(
        np.asarray(mol0.coords)[keep],
        np.asarray([enc[mol0.symbols[i]] for i in keep]), enc,
        model.sample_cfg.lig_pad_multiple, device=model.device), pop)
    pocket = model.pocket_from_pdb(args.pdbfile, args.ref_ligand, pop)

    history, best_mols = [], []
    for gen in range(args.evolution_steps):
        t0 = time.perf_counter()
        res = model.diversify(ligand, pocket, noising_steps=args.timesteps,
                              seed=args.seed + gen)
        mols = model.result_to_molecules(res)
        scores = np.array([score_fn(m) if m is not None else invalid
                           for m in mols])
        top = np.argsort(scores)[::-1][:args.top_k]
        best_mols = [mols[i] for i in top if mols[i] is not None]
        sel = torch.from_numpy(np.tile(top, -(-pop // len(top)))[:pop]).to(
            model.device)
        ligand = NodeBatch(*(a[sel] for a in res.ligand))
        history.append(dict(best=float(scores[top[0]]),
                            mean=float(scores.mean()),
                            seconds=time.perf_counter() - t0))
        print(f"gen {gen}: best {args.objective}={history[-1]['best']:.3f} "
              f"mean={history[-1]['mean']:.3f} "
              f"({history[-1]['seconds']:.3f} s)")
    write_sdf(args.outfile, best_mols)
    print(f"wrote {len(best_mols)} optimized molecules to {args.outfile}")
    return history


if __name__ == "__main__":
    main()
