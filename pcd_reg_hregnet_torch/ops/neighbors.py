"""Exact batched k-nearest neighbours and grouping (port of
`pcd_reg_hregnet_tpu/ops/neighbors.py`, exact branch).

The TPU package's one-hot MXU gathers and approximate top-k are TPU
workarounds; torch has exact native gathers and an exact top-k.
"""
from __future__ import annotations

from typing import Optional

import torch


def pairwise_sqdist(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [B, M, N] between [B, M, D] and [B, N, D]."""
    qn = torch.sum(query * query, dim=-1, keepdim=True)          # [B,M,1]
    dn = torch.sum(database * database, dim=-1, keepdim=True)    # [B,N,1]
    cross = torch.bmm(query, database.transpose(1, 2))
    return torch.clamp_min(qn - 2.0 * cross + dn.transpose(1, 2), 0.0)


def knn(query: torch.Tensor, database: torch.Tensor, k: int):
    """Exact k nearest neighbours, ascending by distance.

    Returns (sqdists [B, M, k], idx [B, M, k] int64).
    """
    d2 = pairwise_sqdist(query, database)
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True)


def knn_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features: [B, N, C] x [B, M, k] -> [B, M, k, C]."""
    rows = torch.arange(data.shape[0], device=data.device)[:, None, None]
    return data[rows, idx]


def knn_group(xyz1: torch.Tensor, xyz2: torch.Tensor,
              features2: Optional[torch.Tensor], k: int):
    """kNN grouping with relative-position features.

    Returns grouped [B, M, k, 4 + C] = (rel_xyz, rel_dist, neigh_feats) and
    knn_xyz [B, M, k, 3].
    """
    _, idx = knn(xyz1, xyz2, k)
    db = xyz2 if features2 is None else torch.cat([xyz2, features2], dim=-1)
    g = knn_gather(db, idx)
    knn_xyz = g[..., :3]
    rela_xyz = knn_xyz - xyz1[:, :, None, :]
    rela_dist = torch.sqrt(torch.sum(rela_xyz * rela_xyz, dim=-1, keepdim=True) + 1e-12)
    parts = [rela_xyz, rela_dist]
    if features2 is not None:
        parts.append(g[..., 3:])
    return torch.cat(parts, dim=-1), knn_xyz
