"""Plain reference of the pocket-conditional EGNN denoiser (DiffSBDD's
``EGNNDynamics`` with ``egnn_dynamics``, arXiv:2210.13695, and the
``configs/*.yml`` of its repository), in plain PyTorch and float32.

It imports nothing of the program.  Weights are a flat dict in the
``x @ kernel`` layout with '/'-joined names, the layout of the exported
parameter trees (``params/`` stripped): ``atom_encoder_l0/kernel`` [in,
out], ``egnn/e_block_0/gcl_0/edge_src_kernel`` and so on
(``param_shapes`` lists them).

Every edge slot is computed densely over [rows, N, H] and weighted by the
0/1 adjacency, in blocks of batch rows.  ``matmul`` selects the
precision of every matrix product: ``"fp32"`` (the reference; TF32 must
be off on the card) or ``"tf32"``, both operands rounded to TF32's 10-bit
mantissa before an fp32 product, the precision below fp32 that the
correctness control uses.

Departures from the published code: none in the arithmetic.  The cross
product's norm takes no gradient where it is 0 (self-edges), as the
exported model does; the forward value is the same.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as the tensor cores take an fp32 operand."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, and the backward's two
    products so too, as the tensor cores compute all three."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        da = g @ tf32_round(b).t()
        # a [..., k] against a shared b [k, n]: db sums over every row
        db = (tf32_round(a).reshape(-1, a.shape[-1]).t()
              @ g.reshape(-1, g.shape[-1]))
        return da, db


class Precision:
    """The matrix product of one precision."""

    def __init__(self, matmul: str = "fp32"):
        if matmul not in ("fp32", "tf32"):
            raise ValueError(f"matmul must be 'fp32' or 'tf32': {matmul!r}")
        self.tf32 = matmul == "tf32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            if torch.is_grad_enabled():
                return _TF32Product.apply(a, b)
            return tf32_round(a) @ tf32_round(b)
        return a @ b


def param_shapes(hp: dict, atom_nf: int, residue_nf: int
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the denoiser of hyperparameters
    ``hp`` (the YAML's ``egnn_params``), in a fixed order."""
    jn, h = hp["joint_nf"], hp["hidden_nf"]
    out = []

    def dense(name, din, dout, bias=True):
        out.append((f"{name}/kernel", (din, dout)))
        if bias:
            out.append((f"{name}/bias", (dout,)))

    for part, nf in (("atom", atom_nf), ("residue", residue_nf)):
        dense(f"{part}_encoder_l0", nf, 2 * nf)
        dense(f"{part}_encoder_l1", 2 * nf, jn)
        dense(f"{part}_decoder_l0", jn, 2 * nf)
        dense(f"{part}_decoder_l1", 2 * nf, nf)
    nf = jn + 1                              # the time is a feature
    dense("egnn/embedding", nf, h)
    for i in range(hp["n_layers"]):
        for k in range(hp.get("inv_sublayers", 1)):
            g = f"egnn/e_block_{i}/gcl_{k}/"
            out += [(g + "edge_src_kernel", (h, h)),
                    (g + "edge_dst_kernel", (h, h)),
                    (g + "edge_dst_bias", (h,)),
                    (g + "edge_edge_kernel", (2, h)),
                    (g + "edge_l2_kernel", (h, h)),
                    (g + "edge_l2_bias", (h,))]
            if hp["attention"]:
                out += [(g + "att_kernel", (h, 1)), (g + "att_bias", (1,))]
            out += [(g + "node_l1_kernel", (2 * h, h)),
                    (g + "node_l1_bias", (h,)),
                    (g + "node_l2_kernel", (h, h)),
                    (g + "node_l2_bias", (h,))]
        e = f"egnn/e_block_{i}/gcl_equiv/"
        chains = ["coord"] + ([] if hp["reflection_equivariant"]
                              else ["cross"])
        for c in chains:
            out += [(e + f"{c}_src_kernel", (h, h)),
                    (e + f"{c}_dst_kernel", (h, h)),
                    (e + f"{c}_dst_bias", (h,)),
                    (e + f"{c}_edge_kernel", (2, h)),
                    (e + f"{c}_l2_kernel", (h, h)),
                    (e + f"{c}_l2_bias", (h,)),
                    (e + f"{c}_out_kernel", (h, 1))]
    dense("egnn/embedding_out", h, nf)
    return out


def adjacency(x_lig, x_pocket, lig_mask, pocket_mask, hp) -> torch.Tensor:
    """[B, N, N] 0/1: ligand pairs within edge_cutoff_ligand (all when
    None), pocket pairs within edge_cutoff_pocket, ligand-pocket pairs
    within edge_cutoff_interaction; self pairs kept; padding excluded."""
    nl = x_lig.shape[1]
    x = torch.cat([x_lig, x_pocket], 1)
    mask = torch.cat([lig_mask, pocket_mask], 1)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    n = x.shape[1]
    lig = torch.arange(n, device=x.device) < nl
    block_ll = lig[:, None] & lig[None, :]
    block_pp = ~lig[:, None] & ~lig[None, :]

    def within(cut):
        if cut is None:
            return torch.ones_like(d2, dtype=torch.bool)
        return d2 <= cut * cut

    keep = torch.where(block_ll, within(hp["edge_cutoff_ligand"]),
                       torch.where(block_pp, within(hp["edge_cutoff_pocket"]),
                                   within(hp["edge_cutoff_interaction"])))
    real = (mask[:, :, None] > 0) & (mask[:, None, :] > 0)
    return (keep & real).float()


class Reference:
    """The denoiser of one configuration: ``eps(xh_lig, xh_pocket, t,
    lig_mask, pocket_mask) -> eps_lig`` [B, NL, 3 + atom_nf]."""

    def __init__(self, w: Weights, hp: dict, matmul: str = "fp32",
                 block_rows: int = 4):
        self.w, self.hp = w, hp
        self.p = Precision(matmul)
        self.block_rows = block_rows
        self.coords_range = float(hp.get("coords_range", 15.0))
        self.norm_constant = float(hp.get("norm_constant", 1.0))
        self.norm_factor = float(hp.get("normalization_factor", 100.0))

    def linear(self, name: str, x: torch.Tensor, bias: bool = True):
        y = self.p.mm(x, self.w[f"{name}/kernel"])
        return y + self.w[f"{name}/bias"] if bias else y

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.linear(f"{name}_l1",
                           F.silu(self.linear(f"{name}_l0", x)))

    def edge_messages(self, pre: str, h_rows, h, d2c, d2i):
        """m_ij = silu(silu(h_i Ws + h_j Wd + bd + d2c_ij we0 + d2i_ij we1)
        W2 + b2) over rows h_rows [B, R, H] and columns h [B, N, H]."""
        w, mm = self.w, self.p.mm
        a = mm(h_rows, w[pre + "_src_kernel"])
        b = mm(h, w[pre + "_dst_kernel"]) + w[pre + "_dst_bias"]
        we = w[pre + "_edge_kernel"]
        feats = torch.stack([d2c, d2i], -1)               # [B, R, N, 2]
        u = a[:, :, None] + b[:, None] + mm(feats, we)
        return F.silu(mm(F.silu(u), w[pre + "_l2_kernel"])
                      + w[pre + "_l2_bias"])

    def gcl(self, g: str, h, d2c, d2i, adj, node_mask):
        w = self.w
        m = self.edge_messages(g + "edge", h, h, d2c, d2i)
        if self.hp["attention"]:
            m = m * torch.sigmoid(self.p.mm(m, w[g + "att_kernel"])
                                  + w[g + "att_bias"])
        agg = (m * adj[..., None]).sum(2) / self.norm_factor
        out = F.silu(self.p.mm(torch.cat([h, agg], -1), w[g + "node_l1_kernel"])
                     + w[g + "node_l1_bias"])
        h = h + self.p.mm(out, w[g + "node_l2_kernel"]) + w[g + "node_l2_bias"]
        return h * node_mask[..., None]

    def coord_update(self, e: str, h, x, d2c, d2i, adj, node_mask, nl):
        """x + the update of the first nl rows (the ligand); the pocket
        rows stay."""
        mf = node_mask[..., None]
        center = (x * mf).sum(1, keepdim=True) / mf.sum(1, keepdim=True
                                                        ).clamp_min(1e-12)
        xr = x[:, :nl]
        total = torch.zeros_like(xr)
        chains = ["coord"] + ([] if self.hp["reflection_equivariant"]
                              else ["cross"])
        for c in chains:
            m = self.edge_messages(e + c, h[:, :nl], h, d2c[:, :nl],
                                   d2i[:, :nl])
            phi = self.p.mm(m, self.w[e + c + "_out_kernel"])[..., 0]
            if self.hp["tanh"]:
                phi = torch.tanh(phi) * self.coords_range
            if c == "coord":
                d = xr[:, :, None] - x[:, None]
                r = torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-8)
                v = d / (r + self.norm_constant)
            else:
                cr = torch.linalg.cross(xr[:, :, None] - center[:, None],
                                        x[:, None] - center[:, None],
                                        dim=-1)
                n2 = (cr * cr).sum(-1, keepdim=True)
                norm = torch.sqrt(n2)
                v = cr / (norm + self.norm_constant)
            total = total + (v * (phi * adj[:, :nl])[..., None]).sum(2) \
                / self.norm_factor
        x = torch.cat([xr + total, x[:, nl:]], 1)
        return x * mf

    def _block(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask):
        hp, nl = self.hp, xh_lig.shape[1]
        x_lig, h_lig = xh_lig[..., :3], xh_lig[..., 3:]
        x_poc, h_poc = xh_pocket[..., :3], xh_pocket[..., 3:]
        h = torch.cat([self.mlp("atom_encoder", h_lig),
                       self.mlp("residue_encoder", h_poc)], 1)
        x = torch.cat([x_lig, x_poc], 1)
        mask = torch.cat([lig_mask, pocket_mask], 1)
        h = torch.cat([h, t.reshape(-1, 1, 1).expand(h.shape[0], h.shape[1],
                                                     1)], -1)
        adj = adjacency(x_lig, x_poc, lig_mask, pocket_mask, hp)
        d2i = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
        x0 = x
        h = self.linear("egnn/embedding", h)
        for i in range(hp["n_layers"]):
            d2c = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
            for k in range(hp.get("inv_sublayers", 1)):
                h = self.gcl(f"egnn/e_block_{i}/gcl_{k}/", h, d2c, d2i, adj,
                             mask)
            x = self.coord_update(f"egnn/e_block_{i}/gcl_equiv/", h, x, d2c,
                                  d2i, adj, mask, nl)
        h = self.linear("egnn/embedding_out", h) * mask[..., None]
        vel = (x - x0) * mask[..., None]
        eps_h = self.mlp("atom_decoder", h[:, :nl, :-1])
        return torch.cat([vel[:, :nl], eps_h], -1) * lig_mask[..., None]

    def eps_rows(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask):
        """eps of all rows at once, with autograd (the caller blocks)."""
        return self._block(xh_lig, xh_pocket, t, lig_mask, pocket_mask)

    @torch.no_grad()
    def eps(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask):
        t = torch.as_tensor(t, dtype=xh_lig.dtype, device=xh_lig.device)
        t = t.expand(xh_lig.shape[0]) if t.dim() == 0 else t
        out = []
        for i in range(0, xh_lig.shape[0], self.block_rows):
            j = slice(i, i + self.block_rows)
            out.append(self._block(xh_lig[j], xh_pocket[j], t[j],
                                   lig_mask[j], pocket_mask[j]))
        return torch.cat(out, 0)

