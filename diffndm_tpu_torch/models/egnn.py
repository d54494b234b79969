"""E(n)-equivariant graph network over padded dense batches.

The counterpart of the JAX package's ``models/egnn.py`` on its fused
kernel path: scalar edge features (current and initial squared distance),
``sum`` aggregation, no sinusoid embedding.  The edge chain of every GCL
and of every coordinate update runs in ``ops.egnn_kernels``.

Layer weights are explicit parameters in the JAX layout (``x @ kernel``)
with the JAX names, so a converted parameter tree loads one to one and the
kernels take the weights without a transpose.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffndm_tpu_torch.config import EGNNConfig
from diffndm_tpu_torch.ops import egnn_kernels as K


def pairwise_d2(x: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> [B, N, N] squared distances."""
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


class _ExplicitParams(nn.Module):
    """Holds named [din, dout] kernels and [dout] biases."""

    def _dense(self, name: str, din: int, dout: int, bias: bool = True,
               gain: float = 1.0) -> None:
        kernel = torch.empty(din, dout)
        nn.init.normal_(kernel, std=gain / din ** 0.5)
        self.register_parameter(f"{name}_kernel", nn.Parameter(kernel))
        if bias:
            self.register_parameter(f"{name}_bias",
                                    nn.Parameter(torch.zeros(dout)))

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = x @ getattr(self, f"{name}_kernel")
        bias = getattr(self, f"{name}_bias", None)
        return y if bias is None else y + bias


class GCL(_ExplicitParams):
    """Edge MLP + optional sigmoid attention + masked-sum aggregation +
    residual node MLP."""

    def __init__(self, cfg: EGNNConfig, edge_nf: int = 2):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_nf
        self._dense("edge_src", h, h, bias=False)
        self._dense("edge_dst", h, h)
        self._dense("edge_edge", edge_nf, h, bias=False)
        self._dense("edge_l2", h, h)
        if cfg.attention:
            self._dense("att", h, 1)
        self._dense("node_l1", 2 * h, h)
        self._dense("node_l2", h, h)

    def forward(self, h, d2c, d2i, adj, node_mask):
        cfg = self.cfg
        a = self._linear("edge_src", h)
        b = self._linear("edge_dst", h)
        if cfg.attention:
            watt, batt = self.att_kernel, self.att_bias
        else:
            watt, batt = h.new_zeros(cfg.hidden_nf, 1), None
        agg = K.gcl_messages(a, b, d2c, d2i, adj, self.edge_edge_kernel,
                             self.edge_l2_kernel, self.edge_l2_bias, watt,
                             batt, attention=cfg.attention,
                             norm_factor=cfg.normalization_factor)
        out = F.silu(self._linear("node_l1", torch.cat([h, agg], dim=-1)))
        h = h + self._linear("node_l2", out)
        return h * node_mask[..., None]


class EquivariantUpdate(_ExplicitParams):
    """Coordinate update: tanh-clamped radial weights on the normalised
    difference direction plus, unless reflection-equivariant, the cross
    product term about the joint centre of mass."""

    def __init__(self, cfg: EGNNConfig, coords_range: float,
                 edge_nf: int = 2):
        super().__init__()
        self.cfg = cfg
        self.coords_range = coords_range
        h = cfg.hidden_nf
        names = ["coord"] + ([] if cfg.reflection_equivariant else ["cross"])
        for name in names:
            self._dense(f"{name}_src", h, h, bias=False)
            self._dense(f"{name}_dst", h, h)
            self._dense(f"{name}_edge", edge_nf, h, bias=False)
            self._dense(f"{name}_l2", h, h)
            self._dense(f"{name}_out", h, 1, bias=False, gain=1e-3)
        self.names = names

    def forward(self, h, x, d2c, d2i, adj, node_mask,
                update_coords_mask: Optional[torch.Tensor] = None,
                coord_rows: Optional[int] = None):
        cfg = self.cfg
        mask_f = node_mask[..., None]
        center = ((x * mask_f).sum(1, keepdim=True)
                  / mask_f.sum(1, keepdim=True).clamp_min(1e-12))
        agg = None
        for name in self.names:
            part = K.edge_vector_reduce(
                self._linear(f"{name}_src", h),
                self._linear(f"{name}_dst", h), d2c, d2i, adj, x, center,
                getattr(self, f"{name}_edge_kernel"),
                getattr(self, f"{name}_l2_kernel"),
                getattr(self, f"{name}_l2_bias"),
                getattr(self, f"{name}_out_kernel"),
                tanh=cfg.tanh, coords_range=self.coords_range,
                norm_constant=cfg.norm_constant, cross=name == "cross",
                norm_factor=cfg.normalization_factor, n_rows=coord_rows)
            agg = part if agg is None else agg + part
        if update_coords_mask is not None:
            agg = agg * update_coords_mask
        x = x + agg
        return x * node_mask[..., None]


class EquivariantBlock(nn.Module):
    """inv_sublayers x GCL + one coordinate update."""

    def __init__(self, cfg: EGNNConfig, coords_range: float):
        super().__init__()
        self.n_gcl = cfg.inv_sublayers
        for i in range(cfg.inv_sublayers):
            self.add_module(f"gcl_{i}", GCL(cfg))
        self.gcl_equiv = EquivariantUpdate(cfg, coords_range)

    def forward(self, h, x, adj, node_mask, d2i, update_coords_mask=None,
                coord_rows=None):
        d2c = pairwise_d2(x)
        for i in range(self.n_gcl):
            h = getattr(self, f"gcl_{i}")(h, d2c, d2i, adj, node_mask)
        x = self.gcl_equiv(h, x, d2c, d2i, adj, node_mask,
                           update_coords_mask, coord_rows)
        return h, x


class EGNN(nn.Module):
    """embed -> n_layers equivariant blocks -> out-embed."""

    def __init__(self, cfg: EGNNConfig, in_node_nf: int, out_node_nf: int):
        super().__init__()
        if cfg.sin_embedding or cfg.aggregation_method != "sum" \
                or cfg.edge_embedding_dim is not None:
            raise NotImplementedError(
                "the port runs the dense kernel path only: no sin "
                "embedding, 'sum' aggregation, no edge-type embedding")
        self.cfg = cfg
        self.embedding = nn.Linear(in_node_nf, cfg.hidden_nf)
        # the reference's per-layer coords_range division is dead code:
        # every block uses the full range
        for i in range(cfg.n_layers):
            self.add_module(f"e_block_{i}",
                            EquivariantBlock(cfg, float(cfg.coords_range)))
        self.embedding_out = nn.Linear(cfg.hidden_nf, out_node_nf)

    def forward(self, h, x, adj, node_mask, update_coords_mask=None,
                coord_rows: Optional[int] = None):
        """h: [B, N, in_node_nf]; x: [B, N, 3]; adj: [B, N, N].
        ``coord_rows``: only the leading rows' coordinates can move
        (conditional mode: the ligand block); the other rows' updates are
        not computed.  Returns (h_out, x_out)."""
        d2i = pairwise_d2(x)       # initial distances, a persistent feature
        h = self.embedding(h)
        for i in range(self.cfg.n_layers):
            h, x = getattr(self, f"e_block_{i}")(
                h, x, adj, node_mask, d2i, update_coords_mask, coord_rows)
        h = self.embedding_out(h)
        return h * node_mask[..., None], x
