"""The CrossDocked test complexes as one flat evaluation directory: each
``<lig>.sdf`` of ``<basedir>/crossdocked_pocket10/<dir>/`` (or of
``<basedir>`` itself) with its receptor PDB copied into ``<outdir>/test/``
as ``<lig>.pdb`` + ``<lig>.sdf``, the layout the sweep CLI reads."""

from __future__ import annotations

import os
import shutil
from typing import Optional


def prepare_crossdocked(basedir: str, outdir: str,
                        split_test_names: Optional[list] = None) -> int:
    """Copy every (receptor, ligand) pair into ``<outdir>/test``; the
    receptor of a ligand is the first PDB of its directory whose stem
    before ``_rec`` starts the ligand's name, else the first PDB there.
    ``split_test_names`` keeps only those ligand stems.  Returns the
    number of complexes copied."""
    os.makedirs(os.path.join(outdir, "test"), exist_ok=True)
    n = 0
    root = os.path.join(basedir, "crossdocked_pocket10")
    if not os.path.isdir(root):
        root = basedir
    for dirpath, _, files in os.walk(root):
        sdfs = [f for f in files if f.endswith(".sdf")]
        pdbs = [f for f in files if f.endswith(".pdb")]
        for sdf in sdfs:
            stem = sdf[:-4]
            rec = next((pdb for pdb in pdbs
                        if stem.startswith(pdb[:-4].split("_rec")[0])),
                       pdbs[0] if pdbs else None)
            if rec is None:
                continue
            name = stem.replace("/", "_")
            if split_test_names is not None and \
                    name not in split_test_names:
                continue
            shutil.copy(os.path.join(dirpath, rec),
                        os.path.join(outdir, "test", f"{name}.pdb"))
            shutil.copy(os.path.join(dirpath, sdf),
                        os.path.join(outdir, "test", f"{name}.sdf"))
            n += 1
    return n


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("basedir")
    p.add_argument("--outdir", required=True)
    args = p.parse_args(argv)
    n = prepare_crossdocked(args.basedir, args.outdir)
    print(f"prepared {n} test complexes in {args.outdir}/test")
    return n


if __name__ == "__main__":
    main()
