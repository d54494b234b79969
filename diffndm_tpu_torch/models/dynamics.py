"""Dynamics wrapper: encodes ligand atoms and pocket atoms into a joint
feature space, builds the cutoff adjacency (and, with
``edge_embedding_dim``, a learned embedding of the three edge types), runs
the EGNN (or, in ``gnn_dynamics`` mode, the plain GNN over [x, h]) and
decodes per-node noise predictions.  Conditional mode freezes the pocket:
only the ligand rows' coordinate updates are computed.  Joint mode
(``update_pocket_coords``) moves every row and projects the velocity onto
the zero centre-of-mass subspace of the whole ligand and pocket cloud.

Two sparsity options of ``EGNNConfig`` mask the adjacency: ``neighbors``
keeps each row's K best-ranked columns (``egnn.neighbor_mask``), and
``band_window`` sorts the pocket along its principal axis and keeps a band
of columns per tile of pocket rows (``models/banding.py``); the outputs
come back in the caller's row order.  A call may run another tile and
window than the config's (``band``): the guidance fan-out's own row tile
(``SampleConfig.fanout_row_tile``) runs the same weights that way."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffndm_tpu_torch.config import EGNNConfig
from diffndm_tpu_torch.models import banding
from diffndm_tpu_torch.models.egnn import (EGNN, GNN, neighbor_mask,
                                           pairwise_d2)
from diffndm_tpu_torch.ops.segment import masked_mean
from diffndm_tpu_torch.utils.profiling import annotate


def build_adjacency(x_lig, x_pocket, lig_mask, pocket_mask,
                    cfg: EGNNConfig) -> torch.Tensor:
    """Dense joint adjacency [B, N, N], N = NL + NP: ligand-ligand within
    edge_cutoff_ligand (complete when None), pocket-pocket within
    edge_cutoff_pocket, cross pairs within edge_cutoff_interaction.
    Self-edges are kept, as the reference keeps the diagonal."""
    nl, npk = x_lig.shape[1], x_pocket.shape[1]
    x = torch.cat([x_lig, x_pocket], dim=1)
    mask = torch.cat([lig_mask, pocket_mask], dim=1)
    d2 = pairwise_d2(x)
    pair = mask[:, :, None] * mask[:, None, :]
    is_lig = torch.cat([torch.ones(nl, device=x.device),
                        torch.zeros(npk, device=x.device)])
    ll = is_lig[:, None] * is_lig[None, :]
    pp = (1 - is_lig)[:, None] * (1 - is_lig)[None, :]
    cross = 1.0 - ll - pp

    def within(cutoff):
        if cutoff is None:
            return torch.ones_like(d2)
        return (d2 <= cutoff ** 2).to(d2.dtype)

    adj = (ll * within(cfg.edge_cutoff_ligand)
           + pp * within(cfg.edge_cutoff_pocket)
           + cross * within(cfg.edge_cutoff_interaction))
    return (adj * pair).float()


def edge_types(nl: int, npk: int, device) -> torch.Tensor:
    """[N, N] edge type by row position: 0 ligand-pocket, 1 ligand-ligand,
    2 pocket-pocket."""
    is_lig = torch.cat([torch.ones(nl, dtype=torch.long, device=device),
                        torch.zeros(npk, dtype=torch.long, device=device)])
    return (is_lig[:, None] * is_lig[None, :]
            + 2 * (1 - is_lig)[:, None] * (1 - is_lig)[None, :])


def update_coords_mask(lig_mask: torch.Tensor, pocket_mask: torch.Tensor
                       ) -> torch.Tensor:
    """[B, N, 1]: 1 on ligand rows, 0 on the frozen pocket rows."""
    return torch.cat([torch.ones_like(lig_mask),
                      torch.zeros_like(pocket_mask)], dim=1)[..., None]


def _take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N, F] rows in the order idx [B, N]."""
    return torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[-1]))


class EGNNDynamics(nn.Module):
    """eps-prediction network.

    forward(xh_lig [B,NL,3+F_a], xh_pocket [B,NP,3+F_r], t [B] or scalar,
            lig_mask [B,NL], pocket_mask [B,NP])
    -> (eps_lig [B,NL,3+F_a], eps_pocket [B,NP,3+F_r])
    """

    def __init__(self, cfg: EGNNConfig, atom_nf: int, residue_nf: int,
                 n_dims: int = 3):
        super().__init__()
        self.cfg = cfg
        self.n_dims = n_dims
        jn = cfg.joint_nf
        self.atom_encoder_l0 = nn.Linear(atom_nf, 2 * atom_nf)
        self.atom_encoder_l1 = nn.Linear(2 * atom_nf, jn)
        self.atom_decoder_l0 = nn.Linear(jn, 2 * atom_nf)
        self.atom_decoder_l1 = nn.Linear(2 * atom_nf, atom_nf)
        self.residue_encoder_l0 = nn.Linear(residue_nf, 2 * residue_nf)
        self.residue_encoder_l1 = nn.Linear(2 * residue_nf, jn)
        self.residue_decoder_l0 = nn.Linear(jn, 2 * residue_nf)
        self.residue_decoder_l1 = nn.Linear(2 * residue_nf, residue_nf)
        nf = jn + (1 if cfg.condition_time else 0)
        in_edge_nf = cfg.edge_embedding_dim or 0
        if cfg.edge_embedding_dim is not None:
            self.edge_embedding = nn.Embedding(3, cfg.edge_embedding_dim)
        if cfg.mode == "egnn_dynamics":
            self.egnn = EGNN(cfg, in_node_nf=nf, out_node_nf=nf,
                             in_edge_nf=in_edge_nf)
        elif cfg.mode == "gnn_dynamics":
            self.gnn = GNN(cfg, in_node_nf=nf + n_dims,
                           out_node_nf=nf + n_dims, in_edge_nf=in_edge_nf)
        else:
            raise ValueError(f"unknown dynamics mode {cfg.mode!r}")

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(getattr(self, f"{name}_l0")(x))
        return getattr(self, f"{name}_l1")(x)

    def forward(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask,
                band: Optional[Tuple[int, Optional[int]]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """band: the (row_tile, band_window) of this call in place of the
        config's.  The call is a ``denoiser.forward`` span, opened inside
        the module's call, after its forward pre-hooks."""
        with annotate("denoiser.forward"):
            return self._forward(xh_lig, xh_pocket, t, lig_mask, pocket_mask,
                                 band)

    def _forward(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask, band):
        cfg, nd = self.cfg, self.n_dims
        row_tile, window = (cfg.row_tile, cfg.band_window) if band is None \
            else band
        nl = xh_lig.shape[1]
        x_lig, h_lig = xh_lig[..., :nd], xh_lig[..., nd:]
        x_poc, h_poc = xh_pocket[..., :nd], xh_pocket[..., nd:]
        pocket_mask_in = pocket_mask
        # the sorted band: the pocket rows along the pocket's principal
        # axis, un-permuted below (edge types and the frozen-pocket mask
        # are by block, which the permutation keeps).  It restricts columns
        # only under sum aggregation and a window narrower than the pocket
        # block (the JAX package's condition); elsewhere it would cost a
        # host sort and change nothing
        perm = None
        if (window is not None and cfg.neighbors is None
                and cfg.mode == "egnn_dynamics"
                and cfg.aggregation_method == "sum"
                and window < x_poc.shape[1]):
            perm, _ = banding.principal_axis_order(x_poc, pocket_mask)
            x_poc, h_poc = _take_rows(x_poc, perm), _take_rows(h_poc, perm)
            pocket_mask = torch.gather(pocket_mask, 1, perm)

        h = torch.cat([self._mlp("atom_encoder", h_lig),
                       self._mlp("residue_encoder", h_poc)], dim=1)
        x = torch.cat([x_lig, x_poc], dim=1)
        mask = torch.cat([lig_mask, pocket_mask], dim=1)
        if cfg.condition_time:
            t = torch.as_tensor(t, dtype=h.dtype, device=h.device)
            h_time = t.reshape(-1, 1, 1).expand(h.shape[0], h.shape[1], 1)
            h = torch.cat([h, h_time], dim=-1)

        adj = build_adjacency(x_lig, x_poc, lig_mask, pocket_mask, cfg)
        n = adj.shape[-1]
        if perm is not None:
            adj = adj * banding.band_mask(n, nl, row_tile, window,
                                          adj.device)
        if cfg.neighbors is not None and cfg.neighbors < n:
            adj = adj * neighbor_mask(x, adj, nl, cfg.neighbors)
        edge_attr = None
        if cfg.edge_embedding_dim is not None:
            emb = self.edge_embedding(edge_types(nl, x_poc.shape[1],
                                                 x.device))
            edge_attr = emb[None].expand(h.shape[0], *emb.shape)
        # joint mode moves every row; conditional mode only the ligand's
        joint = cfg.update_pocket_coords
        if cfg.mode == "egnn_dynamics":
            h_final, x_final = self.egnn(
                h, x.contiguous(), adj, mask,
                update_coords_mask=(None if joint else update_coords_mask(
                    lig_mask, pocket_mask)),
                coord_rows=None if joint else nl, edge_attr=edge_attr)
            vel = (x_final - x) * mask[..., None]
        else:
            out = self.gnn(torch.cat([x, h], dim=-1), adj, mask, edge_attr)
            vel = out[..., :nd] * mask[..., None]
            h_final = out[..., nd:]
        if cfg.condition_time:
            h_final = h_final[..., :-1]
        if perm is not None:
            inv = torch.argsort(perm, dim=1)
            h_final = torch.cat([h_final[:, :nl],
                                 _take_rows(h_final[:, nl:], inv)], dim=1)
            vel = torch.cat([vel[:, :nl], _take_rows(vel[:, nl:], inv)],
                            dim=1)
            mask = torch.cat([lig_mask, pocket_mask_in], dim=1)
        if joint:
            # in the caller's row order
            vel = vel - masked_mean(vel, mask, dim=1, keepdim=True)
            vel = vel * mask[..., None]

        eps_h_lig = self._mlp("atom_decoder", h_final[:, :nl])
        eps_h_poc = self._mlp("residue_decoder", h_final[:, nl:])
        eps_lig = torch.cat([vel[:, :nl], eps_h_lig], dim=-1)
        eps_poc = torch.cat([vel[:, nl:], eps_h_poc], dim=-1)
        return (eps_lig * lig_mask[..., None],
                eps_poc * pocket_mask_in[..., None])
