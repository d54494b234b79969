"""FLOP counts of the EGNN denoiser and the peak rates of the card, to turn
a step time into a share of the card.

Two independent counts of one denoiser forward:

- ``egnn_flops_analytic``: the JAX package's closed form of the dominant
  matmuls (edge and node MLPs over padded dense N^2 edge slots).  The port
  has neither row tiles nor a sorted band: ``row_tile`` and
  ``band_window``, read with ``getattr``, are absent from its
  configuration, so the conditional coordinate chains count the ligand
  rows exactly and every edge slot is dense.
- ``forward_flops``: the forward run once through the plain edge chain on
  the CPU under ``torch.utils.flop_counter.FlopCounterMode``, with one
  operation per output element of each elementwise op and per input
  element of each reduction added to its matmul counts (as XLA's cost
  model counts them).  A count of the model's work at given padded shapes,
  the same whatever implements it; it runs the plain chain only and is
  never called on the kernels' path.

A share of the card is stated against the published peak of the card it
ran on, with that peak beside it.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

# Published dense peaks (no sparsity) of the NVIDIA H100 80GB HBM3 (SXM
# part) at its 700 W power limit, keyed by ``torch.cuda.get_device_name()``
# prefixes; a card set below 700 W runs below them.
PEAK_TFLOPS_BF16 = {"NVIDIA H100 80GB HBM3": 989.0}
PEAK_TFLOPS_TF32 = {"NVIDIA H100 80GB HBM3": 495.0}
PEAK_TFLOPS_FP32 = {"NVIDIA H100 80GB HBM3": 67.0}
# HBM bandwidth (GB/s), for the roofline's ridge point
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

_PEAKS = {"bf16": PEAK_TFLOPS_BF16, "tf32": PEAK_TFLOPS_TF32,
          "fp32": PEAK_TFLOPS_FP32}


def _lookup(table: dict, device_kind: str) -> Optional[float]:
    for prefix, v in table.items():
        if device_kind.startswith(prefix):
            return v
    return None


def peak_tflops_for(device_kind: str, dtype: str = "bf16"
                    ) -> Optional[float]:
    """The card's dense peak in TFLOP/s for ``dtype`` (bf16: the matmul
    peak a model FLOP utilisation is stated against; tf32: the tensor-core
    rate of the port's edge-chain kernels; fp32: outside the tensor
    cores); None for a card not in the tables."""
    return _lookup(_PEAKS[dtype], device_kind)


def hbm_gbps_for(device_kind: str) -> Optional[float]:
    return _lookup(HBM_GBPS, device_kind)


def egnn_flops_analytic(cfg, atom_nf: int, b: int, n_lig: int,
                        n_pocket: int) -> float:
    """Closed-form dominant-matmul FLOPs of one EGNN forward, 2*m*n*k per
    dense layer over nodes and padded dense edge slots:

    per GCL        node: src/dst/n1(2H->H)/n2  = 5*H^2
                   edge: w_l2 H^2 + w_edg e*H + att H
    per EqUpdate   node: coord_src/dst + cross_src/dst = 4*H^2
                   edge: 2 chains of (H^2 + e*H + H) (coord + cross)

    The edge slots are the band's under ``band_window``, else all N^2;
    ``neighbors`` is not counted (the JAX package's closed form does not
    count it either).
    """
    H = cfg.hidden_nf
    e = 1 + (cfg.edge_embedding_dim or 0)  # radial (+ optional embedding)
    n = n_lig + n_pocket
    band = cfg.band_window
    if band:
        edges = n_lig * n + n_pocket * min(n, n_lig + band)
    else:
        edges = n * n
    cross = 0 if cfg.reflection_equivariant else 1
    per_gcl_node = 5 * H * H + H
    per_gcl_edge = H * H + e * H + (H if cfg.attention else 0)
    per_equ_node = (2 + 2 * cross) * H * H
    per_equ_edge = (1 + cross) * (H * H + e * H + H)
    if getattr(cfg, "update_pocket_coords", False):
        equ_edges = edges
    else:
        # conditional mode: the coordinate chains run for the ligand rows
        # only.  The kernels take those rows as they are; the JAX package
        # rounds them up to its row tiles (row_tile), equal to this where
        # n_lig is a whole number of tiles
        equ_edges = min(n_lig, n) * n
    per_layer = (n * (cfg.inv_sublayers * per_gcl_node + per_equ_node)
                 + edges * cfg.inv_sublayers * per_gcl_edge
                 + equ_edges * per_equ_edge)
    embed = n * (cfg.joint_nf + 1) * H + n * H * (cfg.joint_nf + 1)
    return 2.0 * b * (cfg.n_layers * per_layer + embed)


_ELEMENTWISE = ("add", "sub", "mul", "div", "neg", "silu", "sigmoid", "tanh",
                "sqrt", "rsqrt", "exp", "log", "pow", "abs", "clamp",
                "clamp_min", "clamp_max", "maximum", "minimum", "where",
                "linalg_cross", "reciprocal", "sin", "cos", "relu")
_REDUCTIONS = ("sum", "mean", "amax", "amin", "norm", "linalg_vector_norm")


def _op_counts() -> dict:
    """FlopCounterMode formulas for the elementwise ops and reductions,
    which it does not count by itself."""
    import torch

    aten = torch.ops.aten

    def elementwise(*args, out_shape=None, **kwargs):
        return math.prod(out_shape) if out_shape else 1

    def reduction(x_shape, *args, **kwargs):
        return math.prod(x_shape)

    out = {}
    for names, fn in ((_ELEMENTWISE, elementwise), (_REDUCTIONS, reduction)):
        for name in names:
            if hasattr(aten, name):
                out[getattr(aten, name)] = fn
    return out


def forward_flops(dynamics, b: int, n_lig: int, n_pocket: int) -> dict:
    """FLOPs and bytes of one forward of ``dynamics`` (the port's
    ``EGNNDynamics``) at the given padded shapes, counted on a CPU copy
    through the plain edge chain, inputs zero and every row real.

    Returns ``{"flops": float, "bytes": float}``: ``bytes`` sums each op's
    input and output tensors (views excluded), an upper bound on the
    memory traffic, since an op that another feeds without a round trip
    to memory is counted as if it made one, as XLA's "bytes accessed"
    counts them.
    """
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    class BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    model = copy.deepcopy(dynamics).to("cpu").float()
    atom_nf = model.atom_encoder_l0.in_features
    residue_nf = model.residue_encoder_l0.in_features
    z = torch.zeros((b, n_lig, 3 + atom_nf))
    p = torch.zeros((b, n_pocket, 3 + residue_nf))
    t = torch.zeros((b,))
    lm, pm = torch.ones((b, n_lig)), torch.ones((b, n_pocket))
    counter = FlopCounterMode(display=False, custom_mapping=_op_counts())
    nbytes = BytesMode()
    with torch.no_grad(), counter, nbytes:
        model(z, p, t, lm, pm)
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(nbytes.bytes)}
