"""The denoiser's weights as the benchmark hands them to both sides: a
flat dict in the ``x @ kernel`` layout of the exported parameter trees
(``reference.egnn.param_shapes`` names them), made on the device from the
seed or read from an exported ``.npz``; and the same tensors as the
program's ``state_dict`` (an ``nn.Linear`` weight is its kernel
transposed; explicit kernels keep their layout)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.egnn import param_shapes

# the top-level nn.Linear modules of the program's denoiser; every other
# kernel is an explicit [in, out] parameter of the same name
_LINEAR = ("atom_encoder_l0", "atom_encoder_l1", "atom_decoder_l0",
           "atom_decoder_l1", "residue_encoder_l0", "residue_encoder_l1",
           "residue_decoder_l0", "residue_decoder_l1", "egnn/embedding",
           "egnn/embedding_out")


def seeded(hp: dict, atom_nf: int, residue_nf: int, seed: int,
           device, spec: dict) -> Dict[str, torch.Tensor]:
    """Every weight drawn in one normal draw on the device from a
    generator seeded with ``seed``: a kernel [din, dout] with standard
    deviation spec["kernel_gain"] / sqrt(din) (``*_out_kernel``:
    spec["out_gain"] / sqrt(din)), a bias with spec["bias_std"].  The
    difference direction's head (``coord_out_kernel``) has the mean
    spec["coord_out_mean"] / sqrt(din): a positive weight on each
    neighbour's direction, which makes the denoiser's coordinate output
    grow with the ligand's spread, as a trained one's does, so that the
    ligand stays compact over the 500 steps."""
    shapes = param_shapes(hp, atom_nf, residue_nf)
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = []
    for name, shape in shapes:
        if name.endswith("bias"):
            std = spec["bias_std"]
        else:
            gain = (spec["out_gain"] if name.endswith("_out_kernel")
                    else spec["kernel_gain"])
            std = gain / np.sqrt(shape[0])
        scale.append(std)
    per = torch.repeat_interleave(
        torch.tensor(scale, dtype=torch.float32, device=device),
        torch.tensor(sizes, device=device))
    flat = flat * per
    mean = spec.get("coord_out_mean", 0.0)
    out, i = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        out[name] = flat[i:i + n].view(shape)
        if mean and name.endswith("coord_out_kernel"):
            out[name] = out[name] + mean / np.sqrt(shape[0])
        i += n
    return out


def from_npz(path: str, device) -> Dict[str, torch.Tensor]:
    """An exported parameter tree (``params/...`` keys), on the device."""
    with np.load(path) as f:
        return {k[len("params/"):] if k.startswith("params/") else k:
                torch.from_numpy(np.asarray(f[k], np.float32)).to(device)
                for k in f.files}


def state_key(name: str) -> str:
    """The program's ``state_dict`` name of a weight."""
    module, _, leaf = name.rpartition("/")
    if module in _LINEAR:
        return module.replace("/", ".") + (".weight" if leaf == "kernel"
                                           else ".bias")
    return name.replace("/", ".")


def program_state(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The same weights under the program's ``state_dict`` names (an
    ``nn.Linear`` kernel transposed)."""
    state = {}
    for name, value in w.items():
        module, _, leaf = name.rpartition("/")
        if module in _LINEAR and leaf == "kernel":
            value = value.t().contiguous()
        state[state_key(name)] = value
    return state


def from_program(named: Dict[str, torch.Tensor],
                 like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors under the program's parameter names (``named``) back in
    the layout and under the names of ``like`` (an ``nn.Linear`` kernel
    transposed back)."""
    out = {}
    for name in like:
        value = named[state_key(name)]
        module, _, leaf = name.rpartition("/")
        if module in _LINEAR and leaf == "kernel":
            value = value.t()
        out[name] = value
    return out
