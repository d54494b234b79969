"""JAX parameter tree -> the port's ``state_dict``.

The JAX ``EGNNDynamics`` parameters are a nested dict (optionally under a
top-level ``"params"`` key).  Two kinds of leaves occur:

- ``<layer>/kernel`` and ``<layer>/bias`` of a flax ``nn.Dense``: these
  become ``<layer>.weight`` (transposed to torch's [out, in]) and
  ``<layer>.bias`` of an ``nn.Linear``;
- explicit ``<name>_kernel`` / ``<name>_bias`` arrays of the EGNN layers:
  the port keeps them as parameters of the same name and layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}.  A flat dict passes through."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a JAX EGNNDynamics parameter tree (nested, or flat with
    '/'-joined keys) into a state_dict for ``models.dynamics.EGNNDynamics``.
    """
    flat = flatten_tree(tree)
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        value = np.asarray(value, dtype=np.float32)
        if parts[-1] == "kernel":
            key = ".".join(parts[:-1]) + ".weight"
            value = value.T
        elif parts[-1] == "bias":
            key = ".".join(parts[:-1]) + ".bias"
        else:
            key = ".".join(parts)
        if key in state:
            raise ValueError(f"two JAX leaves map to {key}")
        state[key] = torch.tensor(value)
    return state
