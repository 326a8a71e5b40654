"""Chamfer distance loss (port of `pcd_reg_hregnet_tpu/losses/chamfer.py`):
sqrt of the bidirectional nearest-neighbour squared distances, averaged per
direction, halved, with an input scale (the reference uses 50).

The distances are `ops.neighbors.pairwise_sqdist`, the JAX package's
expansion |q|^2 - 2 q.d + |d|^2; `torch.cdist`'s matmul path rounds
differently.
"""
from __future__ import annotations

import torch

from ..ops.neighbors import pairwise_sqdist


def chamfer_distance(template: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Per-batch sqrt-chamfer: [B, N, 3] x [B, M, 3] -> [B]."""
    d2 = pairwise_sqdist(template, source)                 # [B,N,M]
    cost_t_s = torch.sqrt(torch.amin(d2, dim=2) + 1e-12).mean(dim=1)
    cost_s_t = torch.sqrt(torch.amin(d2, dim=1) + 1e-12).mean(dim=1)
    return (cost_t_s + cost_s_t) / 2.0


def chamfer_loss(template: torch.Tensor, source: torch.Tensor,
                 scale: float = 1.0, reduction: str = 'mean') -> torch.Tensor:
    """The chamfer distance of the scaled clouds, reduced over the batch."""
    c = chamfer_distance(template / scale, source / scale)
    if reduction == 'none':
        return c
    if reduction == 'mean':
        return torch.mean(c)
    if reduction == 'sum':
        return torch.sum(c)
    raise ValueError(f'unknown reduction {reduction!r}')
