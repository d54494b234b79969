"""Dynamics wrapper: encodes ligand atoms and pocket atoms into a joint
feature space, builds the cutoff adjacency, runs the EGNN and decodes
per-node noise predictions (conditional mode: the pocket is frozen)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffndm_tpu_torch.config import EGNNConfig
from diffndm_tpu_torch.models.egnn import EGNN, pairwise_d2


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


def update_coords_mask(lig_mask: torch.Tensor, pocket_mask: torch.Tensor
                       ) -> torch.Tensor:
    """[B, N, 1]: 1 on ligand rows, 0 on the frozen pocket rows."""
    return torch.cat([torch.ones_like(lig_mask),
                      torch.zeros_like(pocket_mask)], dim=1)[..., None]


class EGNNDynamics(nn.Module):
    """eps-prediction network.

    forward(xh_lig [B,NL,3+F_a], xh_pocket [B,NP,3+F_r], t [B] or scalar,
            lig_mask [B,NL], pocket_mask [B,NP])
    -> (eps_lig [B,NL,3+F_a], eps_pocket [B,NP,3+F_r])
    """

    def __init__(self, cfg: EGNNConfig, atom_nf: int, residue_nf: int,
                 n_dims: int = 3):
        super().__init__()
        if cfg.update_pocket_coords:
            raise NotImplementedError("the port runs the pocket-conditional "
                                      "model only (frozen pocket)")
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
        self.egnn = EGNN(cfg, in_node_nf=nf, out_node_nf=nf)

    def _mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(getattr(self, f"{name}_l0")(x))
        return getattr(self, f"{name}_l1")(x)

    def forward(self, xh_lig, xh_pocket, t, lig_mask, pocket_mask
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, nd = self.cfg, self.n_dims
        nl = xh_lig.shape[1]
        x_lig, h_lig = xh_lig[..., :nd], xh_lig[..., nd:]
        x_poc, h_poc = xh_pocket[..., :nd], xh_pocket[..., nd:]

        h = torch.cat([self._mlp("atom_encoder", h_lig),
                       self._mlp("residue_encoder", h_poc)], dim=1)
        x = torch.cat([x_lig, x_poc], dim=1)
        mask = torch.cat([lig_mask, pocket_mask], dim=1)
        if cfg.condition_time:
            t = torch.as_tensor(t, dtype=h.dtype, device=h.device)
            h_time = t.reshape(-1, 1, 1).expand(h.shape[0], h.shape[1], 1)
            h = torch.cat([h, h_time], dim=-1)

        adj = build_adjacency(x_lig, x_poc, lig_mask, pocket_mask, cfg)
        h_final, x_final = self.egnn(
            h, x.contiguous(), adj, mask,
            update_coords_mask=update_coords_mask(lig_mask, pocket_mask),
            coord_rows=nl)
        vel = (x_final - x) * mask[..., None]
        if cfg.condition_time:
            h_final = h_final[..., :-1]

        eps_h_lig = self._mlp("atom_decoder", h_final[:, :nl])
        eps_h_poc = self._mlp("residue_decoder", h_final[:, nl:])
        eps_lig = torch.cat([vel[:, :nl], eps_h_lig], dim=-1)
        eps_poc = torch.cat([vel[:, nl:], eps_h_poc], dim=-1)
        return (eps_lig * lig_mask[..., None],
                eps_poc * pocket_mask[..., None])
