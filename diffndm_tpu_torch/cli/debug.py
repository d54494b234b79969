"""Debug utilities (the reference's debug.py, test_for_GPU_pytorch.py and
mine_RDKit.py): the CUDA devices torch sees, the keys and shapes of a
checkpoint, a summary of an SDF file.

Example:
    python -m diffndm_tpu_torch.cli.debug devices
    python -m diffndm_tpu_torch.cli.debug ckpt \
        diffndm_tpu_torch/assets/virtual_cond_v3b_ema.npz
    python -m diffndm_tpu_torch.cli.debug sdf sweep_out/a_gen.sdf
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("devices", help="list the CUDA devices torch sees")
    c = sub.add_parser("ckpt", help="dump checkpoint keys")
    c.add_argument("path")
    s = sub.add_parser("sdf", help="summarize an SDF file")
    s.add_argument("path")
    return p


def devices() -> None:
    import torch

    print("cuda available:", torch.cuda.is_available())
    print("device count:", torch.cuda.device_count())
    for i in range(torch.cuda.device_count()):
        major, minor = torch.cuda.get_device_capability(i)
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)} "
              f"(compute capability {major}.{minor})")


def ckpt(path: str) -> None:
    """Keys and shapes of an ``.npz`` (the JAX parameter tree, flat) or
    of a reference ``.ckpt`` / ``.pth`` / ``.pt`` state dict."""
    if Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?): this package "
            "reads no orbax; export it to an .npz with the one-liner in "
            "README \"PyTorch port (H100)\"")
    if path.endswith((".ckpt", ".pth", ".pt")):
        import torch

        loaded = torch.load(path, map_location="cpu", weights_only=False)
        sd = loaded.get("state_dict", loaded)
        for k, v in sd.items():
            print(k, tuple(v.shape) if hasattr(v, "shape") else type(v))
        return
    import numpy as np

    with np.load(path) as f:
        for k in f.files:
            print(k, f[k].shape)


def sdf(path: str) -> None:
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.chem.sanitize import is_valid

    for i, m in enumerate(read_sdf(path)):
        print(f"mol {i}: {m.n_atoms} atoms, {len(m.bonds)} bonds, "
              f"{len(m.rings)} rings, valid={is_valid(m)}, "
              f"formula={''.join(sorted(m.symbols))}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "devices":
        devices()
    elif args.cmd == "ckpt":
        ckpt(args.path)
    else:
        sdf(args.path)


if __name__ == "__main__":
    main()
