"""E(n)-equivariant graph network over padded dense batches, and the
plain GNN denoiser.

The counterpart of the JAX package's ``models/egnn.py``, with its two edge
chains, chosen by the configuration under the JAX package's own
condition:

- the kernel path: the two scalar edge features (current and initial
  squared distance), ``sum`` aggregation, no sinusoid embedding and no
  extra edge features.  The edge chain of every GCL and of every
  coordinate update runs in ``ops.egnn_kernels``, where the JAX package
  runs its Pallas kernels;
- the dense chain: every other configuration (the sinusoid distance
  embedding, ``mean`` aggregation, extra edge features such as the
  edge-type embedding, and the ``GNN``).  It is the JAX package's
  row-tiled path taken over all rows at once: the edge MLP over [B, N, N]
  edge features and a masked sum (or mean) over the columns.

Under ``compute_dtype = "bfloat16"`` each path rounds where its JAX
counterpart does: the kernel path as the JAX package's Pallas path (h
before the node projections, the coordinates before d2c, which is then
computed in bf16, d2i, adj, W_e, the kernels' product operands, and the
aggregate on the way out), the dense chain as its row-tiled XLA path (h,
the edge features and adj; the direction maths in bf16; sums and the
aggregate in fp32).  Weights stay fp32 in every mode.

The sparsity options leave the chains as they are: K-nearest-neighbour
lists (``neighbor_mask``) and the sorted band (``models/banding.py``) are
masks on the dense [B, N, N] adjacency, which both chains read, so the
same edges are summed as the JAX package's gathered and banded columns.

Layer weights are explicit parameters in the JAX layout (``x @ kernel``)
with the JAX names, so a converted parameter tree loads one to one and the
kernels take the weights without a transpose.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffndm_tpu_torch.config import EGNNConfig
from diffndm_tpu_torch.ops import egnn_kernels as K

# the sinusoid distance embedding's resolution range and frequency ratio
SIN_MAX_RES, SIN_MIN_RES, SIN_DIV = 15.0, 15.0 / 2000.0, 4.0


def pairwise_d2(x: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> [B, N, N] squared distances."""
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def neighbor_mask(x: torch.Tensor, adj: torch.Tensor, n_lig: int,
                  k: int) -> torch.Tensor:
    """[B, N, N] 0/1: the K columns each row keeps, the JAX package's
    ``build_neighbor_lists``.  Columns rank by -d2 + 1e7 * adj + 1e7 *
    ligand-ligand, in float32 and in JAX's order of operations (real
    edges, then the ligand clique, then the nearest first); equal scores go
    to the lower column, as ``jax.lax.top_k`` breaks ties (a stable sort:
    at 1e7 the float32 spacing is 1, so real edges whose d2 differ by
    less than about 1 A^2 tie)."""
    n = x.shape[1]
    is_lig = (torch.arange(n, device=x.device) < n_lig).to(x.dtype)
    ll = is_lig[:, None] * is_lig[None, :]
    score = -pairwise_d2(x) + 1e7 * adj + 1e7 * ll
    k = min(k, n)
    idx = torch.sort(score, dim=-1, descending=True, stable=True
                     ).indices[..., :k]
    return torch.zeros_like(adj).scatter_(-1, idx, 1.0)


def current_d2(x: torch.Tensor, cfg: EGNNConfig) -> torch.Tensor:
    """The kernels' d2c [B, N, N].  In bf16, as the JAX package's compiled
    Pallas path computes it from the rounded coordinates: each difference
    rounded to bf16, its square and the sum in fp32, the sum rounded once
    (XLA fuses the bf16 square and sum)."""
    if cfg.compute_dtype == "float32":
        return pairwise_d2(x)
    xq = K.bf16_round(x)
    d = K.bf16_round(xq[:, :, None, :] - xq[:, None, :, :])
    return K.bf16_round((d * d).sum(-1))


def rounding(cfg: EGNNConfig):
    """The rounding to the config's compute dtype: bf16 or none."""
    return K.rounding(cfg.compute_dtype)


def sinusoid_dims() -> int:
    """Features per distance of ``sinusoid_embed``: sin and cos of each
    frequency."""
    return 2 * (int(math.log(SIN_MAX_RES / SIN_MIN_RES, SIN_DIV)) + 1)


def sinusoid_embed(d2: torch.Tensor) -> torch.Tensor:
    """[...] squared distances -> [..., sinusoid_dims()] sin and cos of
    the distance at geometric frequencies; no gradient flows through it."""
    n_freq = sinusoid_dims() // 2
    freqs = (2 * math.pi * SIN_DIV ** torch.arange(
        n_freq, dtype=d2.dtype, device=d2.device) / SIN_MAX_RES)
    # the root is taken in float64 and rounded once, as IEEE float32 sqrt
    # does: torch's float32 CPU sqrt is off by an ulp on some hosts, and at
    # 2*pi*1024/15 rad per A the last bit of a 7 A distance moves sin by 2e-4
    emb = torch.sqrt((d2[..., None] + 1e-8).double()).to(d2.dtype) * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).detach()


def distance_features(d2: torch.Tensor, cfg: EGNNConfig) -> torch.Tensor:
    """[B, N, N] squared distances -> [B, N, N, 1 or sinusoid_dims()]."""
    return sinusoid_embed(d2) if cfg.sin_embedding else d2[..., None]


def uses_kernels(cfg: EGNNConfig, in_edge_nf: int = 0) -> bool:
    """Whether an EGNN of this configuration runs its edge chains in the
    kernels (two scalar distance features, ``sum``) or densely."""
    return (not cfg.sin_embedding and in_edge_nf == 0
            and cfg.aggregation_method == "sum")


class Edges(NamedTuple):
    """The graph of one block.  The kernel path reads ``d2c`` / ``d2i``
    (current and initial squared distances, [B, N, N]); the dense chain
    reads ``feats`` [B, N, N, E] and, under ``mean``, ``deg`` [B, N, 1]
    (the adjacency's row sums, at least 1)."""
    adj: torch.Tensor
    d2c: Optional[torch.Tensor] = None
    d2i: Optional[torch.Tensor] = None
    feats: Optional[torch.Tensor] = None
    deg: Optional[torch.Tensor] = None


def degree(adj: torch.Tensor, cfg: EGNNConfig) -> Optional[torch.Tensor]:
    """max(row sum, 1) of the adjacency under ``mean`` aggregation."""
    if cfg.aggregation_method == "sum":
        return None
    return adj.sum(-1, keepdim=True).clamp_min(1.0)


def _aggregate(v: torch.Tensor, edges: Edges, cfg: EGNNConfig
               ) -> torch.Tensor:
    """v [B, R, N, F] over the first R rows -> [B, R, F]: the sum over the
    edges, divided by normalization_factor (``sum``) or by the degree
    (any other method, as in the JAX package); both divisors in the
    compute dtype, as the JAX package's dense path takes them."""
    rnd = rounding(cfg)
    rows = v.shape[1]
    agg = (v * edges.adj[:, :rows, :, None]).sum(2)
    if cfg.aggregation_method == "sum":
        nf = cfg.normalization_factor
        if cfg.compute_dtype == "bfloat16":
            nf = rnd(torch.tensor(nf)).item()
        return agg / nf
    return agg / rnd(edges.deg[:, :rows])


class _ExplicitParams(nn.Module):
    """Holds named [din, dout] kernels and [dout] biases."""

    def _dense(self, name: str, din: int, dout: int, bias: bool = True,
               gain: float = 1.0) -> None:
        kernel = torch.empty(din, dout)
        nn.init.normal_(kernel, std=gain / max(din, 1) ** 0.5)
        self.register_parameter(f"{name}_kernel", nn.Parameter(kernel))
        if bias:
            self.register_parameter(f"{name}_bias",
                                    nn.Parameter(torch.zeros(dout)))

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = x @ getattr(self, f"{name}_kernel")
        bias = getattr(self, f"{name}_bias", None)
        return y if bias is None else y + bias

    def _edge_hidden(self, name: str, h_rows: torch.Tensor, h: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
        """The dense chain's first edge layer over rows h_rows [B, R, H]
        and columns h [B, N, H]: silu(a_i + b_j + e_ij W_e), [B, R, N, H]."""
        a = self._linear(f"{name}_src", h_rows)
        b = self._linear(f"{name}_dst", h)
        return F.silu(a[:, :, None, :] + b[:, None, :, :]
                      + feats @ getattr(self, f"{name}_edge_kernel"))


class GCL(_ExplicitParams):
    """Edge MLP + optional sigmoid attention + masked aggregation +
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

    def forward(self, h, edges: Edges, node_mask):
        cfg = self.cfg
        rnd = rounding(cfg)
        hq = rnd(h)
        if edges.feats is None:
            if cfg.attention:
                watt, batt = self.att_kernel, self.att_bias
            else:
                watt, batt = h.new_zeros(cfg.hidden_nf, 1), None
            agg = rnd(K.gcl_messages(
                self._linear("edge_src", hq), self._linear("edge_dst", hq),
                edges.d2c, edges.d2i, edges.adj, rnd(self.edge_edge_kernel),
                self.edge_l2_kernel, self.edge_l2_bias, watt, batt,
                attention=cfg.attention, norm_factor=cfg.normalization_factor,
                compute_dtype=cfg.compute_dtype))
        else:
            m = F.silu(self._linear(
                "edge_l2", self._edge_hidden("edge", hq, hq, edges.feats)))
            if cfg.attention:
                m = m * torch.sigmoid(self._linear("att", m))
            agg = _aggregate(m, edges, cfg)
        out = F.silu(self._linear("node_l1", torch.cat([hq, agg], dim=-1)))
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

    def forward(self, h, x, edges: Edges, node_mask,
                update_coords_mask: Optional[torch.Tensor] = None,
                coord_rows: Optional[int] = None):
        mask_f = node_mask[..., None]
        center = ((x * mask_f).sum(1, keepdim=True)
                  / mask_f.sum(1, keepdim=True).clamp_min(1e-12))
        hq = rounding(self.cfg)(h)
        if edges.feats is None:
            agg = self._kernel_update(hq, x, edges, center, coord_rows)
        else:
            agg = self._dense_update(hq, x, edges, center, coord_rows)
        if update_coords_mask is not None:
            agg = agg * update_coords_mask
        x = x + agg
        return x * node_mask[..., None]

    def _kernel_update(self, h, x, edges: Edges, center, coord_rows):
        """The kernels; the coordinates and the centre stay fp32 in every
        mode (the direction maths), the aggregate is rounded to the
        compute dtype."""
        cfg = self.cfg
        rnd = rounding(cfg)
        kw = dict(tanh=cfg.tanh, coords_range=self.coords_range,
                  norm_constant=cfg.norm_constant,
                  norm_factor=cfg.normalization_factor, n_rows=coord_rows,
                  compute_dtype=cfg.compute_dtype)
        names = self.names
        a = [self._linear(f"{name}_src", h) for name in names]
        b = [self._linear(f"{name}_dst", h) for name in names]
        we, w2, b2, wout = (
            [getattr(self, f"{name}_{part}") for name in names]
            for part in ("edge_kernel", "l2_kernel", "l2_bias", "out_kernel"))
        we = [rnd(w) for w in we]
        if len(names) == 2:
            # difference and cross direction over the same rows and graph:
            # one launch
            return rnd(K.edge_vector_reduce_pair(
                a, b, edges.d2c, edges.d2i, edges.adj, x, center, we, w2, b2,
                wout, **kw))
        return rnd(K.edge_vector_reduce(
            a[0], b[0], edges.d2c, edges.d2i, edges.adj, x, center, we[0],
            w2[0], b2[0], wout[0], cross=False, **kw))

    def _dense_update(self, h, x, edges: Edges, center, coord_rows):
        """The dense chain.  Under ``sum`` only the leading ``coord_rows``
        rows are computed (the rest are frozen and their update is zero),
        as in the JAX package; under ``mean`` every row is.  In bf16 the
        directions are computed in bf16 from rounded coordinates and
        centre, as the JAX package's dense path does."""
        cfg = self.cfg
        n = x.shape[1]
        rows = n
        if coord_rows is not None and cfg.aggregation_method == "sum":
            rows = min(coord_rows, n)
        feats = edges.feats[:, :rows]
        if cfg.compute_dtype == "bfloat16":
            x, center = x.to(torch.bfloat16), center.to(torch.bfloat16)
        xr = x[:, :rows]

        def phi(name):
            z = self._edge_hidden(name, h[:, :rows], h, feats)
            return self._linear(f"{name}_out",
                                F.silu(self._linear(f"{name}_l2", z)))

        d = xr[:, :, None, :] - x[:, None, :, :]
        radial = (d * d).sum(-1, keepdim=True)
        diff = (d / (torch.sqrt(radial + 1e-8) + cfg.norm_constant)).float()
        p = phi("coord")
        trans = (diff * torch.tanh(p) * self.coords_range if cfg.tanh
                 else diff * p)
        if "cross" in self.names:
            pc = phi("cross")
            if cfg.tanh:
                pc = torch.tanh(pc) * self.coords_range
            ctr = center[:, :, None, :]
            cr = torch.linalg.cross(xr[:, :, None, :] - ctr,
                                    x[:, None, :, :] - ctr)
            # padded pairs sit at the origin and self-edges give a zero
            # cross product: no gradient through the norm there (the
            # double where), the value unchanged
            n2 = (cr * cr).sum(-1, keepdim=True)
            pos = n2 > 0
            norm = torch.where(pos, torch.sqrt(torch.where(
                pos, n2, torch.ones_like(n2))), torch.zeros_like(n2))
            trans = trans + (cr / (norm + cfg.norm_constant)).float() * pc
        agg = _aggregate(trans, edges, cfg)
        if rows < n:
            agg = F.pad(agg, (0, 0, 0, n - rows))
        return agg


class EquivariantBlock(nn.Module):
    """inv_sublayers x GCL + one coordinate update."""

    def __init__(self, cfg: EGNNConfig, coords_range: float, edge_nf: int,
                 kernels: bool):
        super().__init__()
        self.cfg = cfg
        self.kernels = kernels
        self.n_gcl = cfg.inv_sublayers
        for i in range(cfg.inv_sublayers):
            self.add_module(f"gcl_{i}", GCL(cfg, edge_nf))
        self.gcl_equiv = EquivariantUpdate(cfg, coords_range, edge_nf)

    def forward(self, h, x, adj, node_mask, e0, deg=None,
                update_coords_mask=None, coord_rows=None):
        """e0: the persistent edge features, the initial squared
        distances [B, N, N] on the kernel path, else [B, N, N, E0] (the
        initial distance features and the extra ones), rounded to the
        compute dtype as the chain reads them."""
        rnd = rounding(self.cfg)
        if self.kernels:
            edges = Edges(adj, d2c=current_d2(x, self.cfg), d2i=e0)
        else:
            feats = torch.cat([distance_features(pairwise_d2(x), self.cfg),
                               e0], dim=-1)
            edges = Edges(adj, feats=rnd(feats), deg=deg)
        for i in range(self.n_gcl):
            h = getattr(self, f"gcl_{i}")(h, edges, node_mask)
        x = self.gcl_equiv(h, x, edges, node_mask, update_coords_mask,
                           coord_rows)
        return h, x


class EGNN(nn.Module):
    """embed -> n_layers equivariant blocks -> out-embed."""

    def __init__(self, cfg: EGNNConfig, in_node_nf: int, out_node_nf: int,
                 in_edge_nf: int = 0):
        super().__init__()
        self.cfg = cfg
        self.kernels = uses_kernels(cfg, in_edge_nf)
        dist_nf = sinusoid_dims() if cfg.sin_embedding else 1
        edge_nf = 2 * dist_nf + in_edge_nf
        self.embedding = nn.Linear(in_node_nf, cfg.hidden_nf)
        # the reference's per-layer coords_range division is dead code:
        # every block uses the full range
        for i in range(cfg.n_layers):
            self.add_module(f"e_block_{i}", EquivariantBlock(
                cfg, float(cfg.coords_range), edge_nf, self.kernels))
        self.embedding_out = nn.Linear(cfg.hidden_nf, out_node_nf)

    def forward(self, h, x, adj, node_mask, update_coords_mask=None,
                coord_rows: Optional[int] = None,
                edge_attr: Optional[torch.Tensor] = None):
        """h: [B, N, in_node_nf]; x: [B, N, 3]; adj: [B, N, N];
        edge_attr: [B, N, N, in_edge_nf] extra edge features, or None.
        ``coord_rows``: only the leading rows' coordinates can move
        (conditional mode: the ligand block).  Returns (h_out, x_out)."""
        cfg = self.cfg
        d2i = pairwise_d2(x)       # initial distances, a persistent feature
        deg = None
        adj = rounding(cfg)(adj)
        if self.kernels:
            e0 = rounding(cfg)(d2i)
        else:
            e0 = distance_features(d2i, cfg)
            if edge_attr is not None:
                e0 = torch.cat([e0, edge_attr], dim=-1)
            deg = degree(adj, cfg)
        h = self.embedding(h)
        for i in range(cfg.n_layers):
            h, x = getattr(self, f"e_block_{i}")(
                h, x, adj, node_mask, e0, deg, update_coords_mask,
                coord_rows)
        h = self.embedding_out(h)
        return h * node_mask[..., None], x


class GNN(nn.Module):
    """The non-equivariant denoiser over the concatenated [x, h]: embed ->
    n_layers GCLs on the dense chain, whose edge features are the extra
    ones only (none, when in_edge_nf is 0) -> out-embed."""

    def __init__(self, cfg: EGNNConfig, in_node_nf: int, out_node_nf: int,
                 in_edge_nf: int = 0):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Linear(in_node_nf, cfg.hidden_nf)
        for i in range(cfg.n_layers):
            self.add_module(f"gcl_{i}", GCL(cfg, in_edge_nf))
        self.embedding_out = nn.Linear(cfg.hidden_nf, out_node_nf)

    def forward(self, xh, adj, node_mask,
                edge_attr: Optional[torch.Tensor] = None):
        """xh: [B, N, in_node_nf]; adj: [B, N, N]; edge_attr: [B, N, N,
        in_edge_nf] or None.  Returns [B, N, out_node_nf]."""
        cfg = self.cfg
        if edge_attr is None:
            b, n = xh.shape[:2]
            edge_attr = xh.new_zeros(b, n, n, 0)
        rnd = rounding(cfg)
        adj = rnd(adj)
        edges = Edges(adj, feats=rnd(edge_attr), deg=degree(adj, cfg))
        h = self.embedding(xh)
        for i in range(cfg.n_layers):
            h = getattr(self, f"gcl_{i}")(h, edges, node_mask)
        h = self.embedding_out(h)
        return h * node_mask[..., None]
