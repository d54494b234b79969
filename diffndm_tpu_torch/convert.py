"""JAX parameter tree -> the port's ``state_dict``, and the reference
PyTorch checkpoint -> a JAX-shaped tree.

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


def adjust_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The flax AdjustNet tree (``fc1``/``fc2`` Dense layers, optionally
    under ``"params"``) -> the state_dict of ``models.adjust_net.AdjustNet``."""
    state = params_from_jax(tree)
    expected = {f"fc{i}.{k}" for i in (1, 2) for k in ("weight", "bias")}
    if set(state) != expected:
        raise ValueError(f"not an AdjustNet tree: {sorted(state)}")
    return state


# -- the reference implementation's Lightning checkpoint ------------------------

def _split_first_edge_layer(w: np.ndarray, b: np.ndarray, hidden: int):
    """The reference's first edge-MLP layer, torch [H, 2H+E] over the
    [h_i; h_j; e_ij] concat -> the three flax-layout kernels (src, dst,
    edge) and the bias."""
    return (w[:, :hidden].T, w[:, hidden:2 * hidden].T, w[:, 2 * hidden:].T,
            b)


def convert_state_dict(sd: Mapping[str, np.ndarray], cfg) -> dict:
    """A reference state dict (keys from ``dynamics.``) -> the JAX
    package's EGNNDynamics parameter tree (flax layout, numpy leaves),
    which ``params_from_jax`` takes."""
    H = cfg.egnn.hidden_nf
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p: dict = {}

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T,
                "bias": sd[f"{prefix}.bias"]}

    for name in ("atom_encoder", "atom_decoder", "residue_encoder",
                 "residue_decoder"):
        # torch nn.Sequential(Linear, SiLU, Linear): Linears at 0 and 2
        p[f"{name}_l0"] = dense(f"dynamics.{name}.0")
        p[f"{name}_l1"] = dense(f"dynamics.{name}.2")

    egnn = {"embedding": dense("dynamics.egnn.embedding"),
            "embedding_out": dense("dynamics.egnn.embedding_out")}
    for bi in range(cfg.egnn.n_layers):
        bp = f"dynamics.egnn.e_block_{bi}"
        block: dict = {}
        for gi in range(cfg.egnn.inv_sublayers):
            gp = f"{bp}.gcl_{gi}"
            src, dst, edg, bias = _split_first_edge_layer(
                sd[f"{gp}.edge_mlp.0.weight"], sd[f"{gp}.edge_mlp.0.bias"],
                H)
            g = {"edge_src_kernel": src, "edge_dst_kernel": dst,
                 "edge_edge_kernel": edg, "edge_dst_bias": bias,
                 "edge_l2_kernel": sd[f"{gp}.edge_mlp.2.weight"].T,
                 "edge_l2_bias": sd[f"{gp}.edge_mlp.2.bias"],
                 "node_l1_kernel": sd[f"{gp}.node_mlp.0.weight"].T,
                 "node_l1_bias": sd[f"{gp}.node_mlp.0.bias"],
                 "node_l2_kernel": sd[f"{gp}.node_mlp.2.weight"].T,
                 "node_l2_bias": sd[f"{gp}.node_mlp.2.bias"]}
            if f"{gp}.att_mlp.0.weight" in sd:
                g["att_kernel"] = sd[f"{gp}.att_mlp.0.weight"].T
                g["att_bias"] = sd[f"{gp}.att_mlp.0.bias"]
            block[f"gcl_{gi}"] = g
        ep = f"{bp}.gcl_equiv"
        eq: dict = {}
        for torch_name, ours in (("coord_mlp", "coord"),
                                 ("cross_product_mlp", "cross")):
            if f"{ep}.{torch_name}.0.weight" not in sd:
                continue
            src, dst, edg, bias = _split_first_edge_layer(
                sd[f"{ep}.{torch_name}.0.weight"],
                sd[f"{ep}.{torch_name}.0.bias"], H)
            eq.update({f"{ours}_src_kernel": src, f"{ours}_dst_kernel": dst,
                       f"{ours}_edge_kernel": edg, f"{ours}_dst_bias": bias,
                       f"{ours}_l2_kernel":
                           sd[f"{ep}.{torch_name}.2.weight"].T,
                       f"{ours}_l2_bias": sd[f"{ep}.{torch_name}.2.bias"],
                       f"{ours}_out_kernel":
                           sd[f"{ep}.{torch_name}.4.weight"].T})
        block["gcl_equiv"] = eq
        egnn[f"e_block_{bi}"] = block
    if "dynamics.edge_embedding.weight" in sd:
        p["edge_embedding"] = {
            "embedding": sd["dynamics.edge_embedding.weight"]}
    p["egnn"] = egnn
    return {"params": p}


def load_reference_checkpoint(path: str, cfg) -> Dict[str, torch.Tensor]:
    """A Lightning ``.ckpt`` (or a raw state dict) of the reference
    implementation -> the port's EGNNDynamics state_dict.  The file is
    unpickled in full (Lightning stores its hyper-parameters as Python
    objects): load only checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("ddpm."):] if k.startswith("ddpm.") else k):
          (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    return params_from_jax(convert_state_dict(sd, cfg))
