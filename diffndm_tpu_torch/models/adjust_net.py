"""AdjustNet: the RL noise-adjustment policy.

A two-layer MLP over per-node latents whose output is added to the
denoiser's eps at every reverse step, with its own Adam optimizer,
trained by REINFORCE after a generation (``sampler.rl_update``).

Checkpoints are ``.npz`` files in the JAX package's layout, so that one
moves between the two packages in both directions:

- ``adjust_net.fc{1,2}.{weight,bias}``: the weights in torch's
  [out, in] layout;
- ``optimizer_state_dict.{i}``: the leaves of the optax ``adam`` state
  in ``jax.tree.flatten`` order (``OPTAX_ADAM_LEAVES``), kernels in
  flax's [in, out] layout.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from diffndm_tpu_torch.config import RLConfig

# jax.tree.flatten(optax.adam(lr).init(params)) for the flax AdjustNet:
# the step count, then the first and the second moments, each in the
# tree's key order
OPTAX_ADAM_LEAVES = ("count",
                     "mu/fc1/bias", "mu/fc1/kernel",
                     "mu/fc2/bias", "mu/fc2/kernel",
                     "nu/fc1/bias", "nu/fc1/kernel",
                     "nu/fc2/bias", "nu/fc2/kernel")
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq"}


class AdjustNet(nn.Module):
    def __init__(self, input_dim: int = 13, hidden_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, input_dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """nn.Linear's own initialisation, drawn from ``generator``."""
        for layer in (self.fc1, self.fc2):
            nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5),
                                     generator=generator)
            bound = 1.0 / math.sqrt(layer.in_features)
            nn.init.uniform_(layer.bias, -bound, bound, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(z)))


class AdjustNetState:
    """The policy, its Adam optimizer, the REINFORCE step and the
    checkpoint format.  ``history`` holds (loss, grad_norm, reward) of
    every update."""

    def __init__(self, cfg: RLConfig, device="cpu",
                 generator: Optional[torch.Generator] = None):
        """generator: a CPU generator for the initial weights (seed 0 when
        not given)."""
        self.cfg = cfg
        self.module = AdjustNet(cfg.input_dim, cfg.hidden_dim)
        with torch.no_grad():
            self.module.reset_parameters(
                generator or torch.Generator().manual_seed(0))
        self.module.to(device)
        self.optimizer = torch.optim.Adam(self.module.parameters(),
                                          lr=cfg.lr)
        self.history: List[Tuple[float, float, float]] = []

    def _layers(self):
        return (("fc1", self.module.fc1), ("fc2", self.module.fc2))

    def reinforce(self, z_stack: torch.Tensor, eps_stack: torch.Tensor,
                  lig_mask: torch.Tensor, reward: float,
                  reward_scale: float) -> Tuple[float, float]:
        """One REINFORCE step on the stacks [T, B, NL, F] of a trajectory:
        loss = reward * (-0.5 * mean(((net(z) - eps) * mask)^2)) * scale,
        the gradient through the policy only, one Adam step.  Returns
        (loss, grad_norm) and records them with the reward."""
        z_stack, eps_stack = z_stack.detach(), eps_stack.detach()
        ml = lig_mask.detach()[None, ..., None]
        with torch.enable_grad():
            adj = self.module(z_stack)
            log_prob = -0.5 * (((adj - eps_stack) * ml) ** 2).mean()
            loss = reward * log_prob * reward_scale
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        grad_norm = torch.sqrt(sum((p.grad ** 2).sum()
                                   for p in self.module.parameters()))
        self.optimizer.step()
        out = (float(loss.detach()), float(grad_norm))
        self.history.append(out + (float(reward),))
        return out

    # -- checkpoint -----------------------------------------------------------
    def save(self, path: str) -> None:
        flat = {}
        for name, layer in self._layers():
            flat[f"adjust_net.{name}.weight"] = \
                layer.weight.detach().cpu().numpy()
            flat[f"adjust_net.{name}.bias"] = layer.bias.detach().cpu().numpy()
        count = 0
        for i, leaf in enumerate(OPTAX_ADAM_LEAVES):
            if leaf == "count":
                state = self.optimizer.state.get(self.module.fc1.weight, {})
                if "step" in state:
                    count = int(state["step"])
                flat[f"optimizer_state_dict.{i}"] = np.asarray(count,
                                                               np.int32)
                continue
            moment, name, kind = leaf.split("/")
            param = self._param(name, kind)
            state = self.optimizer.state.get(param, {})
            value = (state[_MOMENTS[moment]].detach().cpu().numpy()
                     if _MOMENTS[moment] in state
                     else np.zeros(tuple(param.shape), np.float32))
            flat[f"optimizer_state_dict.{i}"] = \
                value.T if kind == "kernel" else value
        np.savez(path, **flat)

    def _param(self, name: str, kind: str) -> torch.Tensor:
        layer = getattr(self.module, name)
        return layer.weight if kind == "kernel" else layer.bias

    def load(self, path: str) -> None:
        """Weights, and the Adam state when the file holds the full optax
        layout (otherwise the optimizer keeps its state, as the JAX
        package does)."""
        with np.load(path, allow_pickle=False) as data:
            self._load_weights({k: data[k] for k in data.files
                                if k.startswith("adjust_net.")})
            opt_keys = sorted(
                (k for k in data.files
                 if k.startswith("optimizer_state_dict.")),
                key=lambda k: int(k.split(".")[-1]))
            if len(opt_keys) != len(OPTAX_ADAM_LEAVES):
                return
            leaves = dict(zip(OPTAX_ADAM_LEAVES,
                              (data[k] for k in opt_keys)))
        step = torch.tensor(float(leaves["count"]), dtype=torch.float32)
        for name, _ in self._layers():
            for kind in ("bias", "kernel"):
                param = self._param(name, kind)
                state = {"step": step.clone()}
                for moment, key in _MOMENTS.items():
                    value = leaves[f"{moment}/{name}/{kind}"]
                    value = value.T if kind == "kernel" else value
                    state[key] = torch.tensor(np.ascontiguousarray(value),
                                              dtype=param.dtype,
                                              device=param.device)
                self.optimizer.state[param] = state

    def _load_weights(self, flat: dict) -> None:
        with torch.no_grad():
            for name, _ in self._layers():
                for kind, attr in (("kernel", "weight"), ("bias", "bias")):
                    self._param(name, kind).copy_(torch.from_numpy(
                        np.asarray(flat[f"adjust_net.{name}.{attr}"])))

    @staticmethod
    def load_torch_state_dict(path: str, cfg: RLConfig,
                              device="cpu") -> "AdjustNetState":
        """The policy's weights from a checkpoint of the reference PyTorch
        implementation (``adjust_net.*`` keys; the optimizer state there
        is not read)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state = AdjustNetState(cfg, device=device)
        state._load_weights({k: v.numpy() for k, v in ckpt.items()
                             if k.startswith("adjust_net.")})
        return state
