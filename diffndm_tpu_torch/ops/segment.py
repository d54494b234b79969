"""Masked reductions over the node axis of padded [B, N, D] batches."""

from __future__ import annotations

import torch


def _expand(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    m = mask.unsqueeze(-1) if mask.dim() == x.dim() - 1 else mask
    return m.to(x.dtype)


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim: int = 1,
               keepdim: bool = False) -> torch.Tensor:
    """Sum of x over ``dim`` counting only entries where mask is set;
    mask is [B, N] against x [B, N, D], or x's own shape."""
    return (x * _expand(mask, x)).sum(dim=dim, keepdim=keepdim)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 1,
                keepdim: bool = False, eps: float = 1e-12) -> torch.Tensor:
    """Masked mean over ``dim``."""
    m = _expand(mask, x)
    total = (x * m).sum(dim=dim, keepdim=keepdim)
    count = m.sum(dim=dim, keepdim=keepdim)
    return total / count.clamp_min(eps)


def sum_except_batch(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], mask [B, N] -> [B]: the sum of all masked entries."""
    return (x * mask.unsqueeze(-1).to(x.dtype)).sum(dim=(-2, -1))


def remove_mean_ligand(x_lig: torch.Tensor, x_pocket: torch.Tensor,
                       lig_mask: torch.Tensor, pocket_mask: torch.Tensor):
    """Subtract the ligand centre of mass from ligand and pocket
    coordinates (conditional-model convention)."""
    mean = masked_mean(x_lig, lig_mask, dim=1, keepdim=True)  # [B, 1, 3]
    x_lig = (x_lig - mean) * lig_mask.unsqueeze(-1).to(x_lig.dtype)
    x_pocket = (x_pocket - mean) * pocket_mask.unsqueeze(-1).to(
        x_pocket.dtype)
    return x_lig, x_pocket


def remove_mean_joint(x_lig: torch.Tensor, x_pocket: torch.Tensor,
                      lig_mask: torch.Tensor, pocket_mask: torch.Tensor):
    """Subtract the joint (ligand and pocket) centre of mass from both
    parts (joint-model convention)."""
    ml = lig_mask.unsqueeze(-1).to(x_lig.dtype)
    mp = pocket_mask.unsqueeze(-1).to(x_pocket.dtype)
    total = (x_lig * ml).sum(1) + (x_pocket * mp).sum(1)
    count = ml.sum((1, 2)) + mp.sum((1, 2))
    mean = (total / count.clamp_min(1e-12)[:, None])[:, None, :]
    return (x_lig - mean) * ml, (x_pocket - mean) * mp
