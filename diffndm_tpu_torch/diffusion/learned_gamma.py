"""The learned monotone noise schedule (a VDM-style gamma network).

The JAX package's ``diffusion/learned_gamma.py``: ``PositiveLinear``
layers with softplus-positive weights make gamma_tilde monotone in t; the
output is normalised to [0, 1] over the unit interval and rescaled to the
learned [gamma_0, gamma_1].  It is trained with the VLB objective only.
The port evaluates the same function with the normalisation's
differences taken before rounding (``GammaNetwork._from_zero``).

``LearnedGamma`` wraps a ``GammaNetwork`` behind the interface of
``schedules.GammaSchedule`` (``__call__(t_norm)``, ``at_step``, ``table``,
``timesteps``), so the diffusion cores take either.  It evaluates the
network at t itself, where ``GammaSchedule`` rounds t to a table index.
Everything it returns carries the network's gradient when grad is on.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class PositiveLinear(nn.Module):
    """x @ softplus(kernel) + bias, kernel in the JAX layout [din, dout].
    Initialised as flax's kaiming_uniform shifted by weight_init_offset, so
    that the initial effective weights are small."""

    def __init__(self, din: int, dout: int, weight_init_offset: float = -2.0):
        super().__init__()
        bound = math.sqrt(6.0 / din)
        self.kernel = nn.Parameter(
            torch.empty(din, dout).uniform_(-bound, bound)
            + weight_init_offset)
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ F.softplus(self.kernel) + self.bias


class GammaNetwork(nn.Module):
    """Monotone gamma(t) = gamma_0 + (gamma_1 - gamma_0) * (g(t) - g(0)) /
    (g(1) - g(0)), g(t) = l1(t) + l3(sigmoid(l2(l1(t))))."""

    def __init__(self, hidden: int = 1024):
        super().__init__()
        self.l1 = PositiveLinear(1, 1)
        self.l2 = PositiveLinear(1, hidden)
        self.l3 = PositiveLinear(hidden, 1)
        self.gamma_0 = nn.Parameter(torch.full((1,), -5.0))
        self.gamma_1 = nn.Parameter(torch.full((1,), 10.0))

    def _from_zero(self, t: torch.Tensor) -> torch.Tensor:
        """g(t) - g(0), [n, 1] for t [n, 1], every layer's bias cancelled
        before it is rounded: l1 and l2 are linear, so their differences
        are t W1 and t W1 W2 (positive for t > 0); sigmoid(a) -
        sigmoid(b) = sign(a - b) sigmoid(max) sigmoid(-min) (1 - exp(-|a -
        b|)); the sum over the hidden units then adds terms of one sign."""
        zero = t.new_zeros(1, 1)
        d1 = t @ F.softplus(self.l1.kernel)
        d2 = d1 @ F.softplus(self.l2.kernel)
        b = self.l2(self.l1(zero))
        a = b + d2
        ds = (torch.sign(d2) * torch.sigmoid(torch.maximum(a, b))
              * torch.sigmoid(-torch.minimum(a, b))
              * -torch.expm1(-d2.abs()))
        return d1 + ds @ F.softplus(self.l3.kernel)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t: normalised times, any shape -> gamma of the same shape.

        The normalised (g(t) - g(0)) / (g(1) - g(0)) of the JAX package,
        with the differences taken in ``_from_zero`` rather than between
        two rounded sums of 1024 terms: a fresh network's g(1) - g(0) is a
        few % of g, so the difference of the sums leaves gamma ~1e-4 off
        in float32, and a VLB weight 1 - exp(gamma_s - gamma_t) one step
        apart at T = 500 (a difference of 0.03) ~1e-2."""
        shape = t.shape
        t = t.reshape(-1, 1)
        one = torch.ones(1, 1, dtype=t.dtype, device=t.device)
        d = self._from_zero(torch.cat([one, t]))
        gamma = self.gamma_0 + (self.gamma_1 - self.gamma_0) * (d[1:] / d[:1])
        return gamma.reshape(shape)


class LearnedGamma:
    """``GammaSchedule``'s interface over a ``GammaNetwork`` (whose
    parameters the trainer trains when the schedule is learned)."""

    def __init__(self, network: GammaNetwork, timesteps: int):
        self.network = network
        self.timesteps = timesteps

    def _as(self, v) -> torch.Tensor:
        g0 = self.network.gamma_0
        return torch.as_tensor(v, device=g0.device).to(g0.dtype)

    def __call__(self, t_norm) -> torch.Tensor:
        """gamma at normalised time t in [0, 1]; any shape."""
        return self.network(self._as(t_norm))

    def at_step(self, step) -> torch.Tensor:
        """gamma at integer step index (0..T)."""
        return self(self._as(step) / self.timesteps)

    @property
    def table(self) -> torch.Tensor:
        """gamma at every step 0..T, [T + 1]."""
        return self.at_step(torch.arange(self.timesteps + 1))
