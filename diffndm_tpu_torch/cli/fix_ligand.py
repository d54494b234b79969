"""Build inpainting fixtures: a connected fragment of about a quarter of
each ligand's atoms, written as its own SDF.

Example:
    python -m diffndm_tpu_torch.cli.fix_ligand ligands/ --outdir frags/ \
        --fraction 0.25

Every ``<name>.sdf`` of the directory gives ``<name>_frag.sdf`` (from its
first record), the input of ``cli.inpaint --fix_atoms``.
"""

from __future__ import annotations

import argparse
import os


def extract_fragment(mol, fraction: float = 0.25):
    """The connected fragment of max(1, int(n_atoms * fraction)) atoms
    grown breadth-first from atom 0, neighbours in bond order, as a
    sub-molecule with its atoms in index order."""
    n_keep = max(1, int(mol.n_atoms * fraction))
    seen = [0]
    frontier = [0]
    while frontier and len(seen) < n_keep:
        nxt = []
        for u in frontier:
            for v in mol.neighbors[u]:
                if v not in seen and len(seen) < n_keep:
                    seen.append(v)
                    nxt.append(v)
        frontier = nxt
    return mol.subgraph(sorted(seen))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("sdf_dir", type=str)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--fraction", type=float, default=0.25)
    return p


def main(argv=None):
    """Returns the paths written."""
    args = build_parser().parse_args(argv)
    from diffndm_tpu_torch.chem.io import read_sdf, write_sdf

    os.makedirs(args.outdir, exist_ok=True)
    written = []
    for f in sorted(os.listdir(args.sdf_dir)):
        if not f.endswith(".sdf"):
            continue
        mols = read_sdf(os.path.join(args.sdf_dir, f))
        if not mols:
            continue
        out = os.path.join(args.outdir, f.replace(".sdf", "_frag.sdf"))
        write_sdf(out, [extract_fragment(mols[0], args.fraction)])
        written.append(out)
    print(f"extracted {len(written)} fragments to {args.outdir}")
    return written


if __name__ == "__main__":
    main()
