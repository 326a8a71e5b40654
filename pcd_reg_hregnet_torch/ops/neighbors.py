"""Exact batched k-nearest neighbours and grouping (port of
`pcd_reg_hregnet_tpu/ops/neighbors.py`, exact branch).

The TPU package's one-hot MXU gathers and approximate top-k are TPU
workarounds; torch has exact native gathers and an exact top-k.
"""
from __future__ import annotations

from typing import Optional

import torch


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """sum(x * x) over the last axis; in bf16 as XLA fuses it (f32 squares
    and sum, rounded once)."""
    if x.dtype.itemsize >= 4:
        return torch.sum(x * x, dim=-1, keepdim=True)
    return torch.sum(x.float() * x.float(), dim=-1, keepdim=True).to(x.dtype)


def pairwise_sqdist(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances [B, M, N] between [B, M, D] and [B, N, D]."""
    qn = _sum_sq(query)                                         # [B,M,1]
    dn = _sum_sq(database)                                      # [B,N,1]
    cross = torch.bmm(query, database.transpose(1, 2))
    return torch.clamp_min(qn - 2.0 * cross + dn.transpose(1, 2), 0.0)


def knn(query: torch.Tensor, database: torch.Tensor, k: int):
    """Exact k nearest neighbours, ascending by distance, and among equal
    distances the lower index first, as the JAX package's `top_k` takes
    them (`torch.topk` promises no order of ties, and bf16 descriptor
    distances tie often).

    One float `topk` of k + 1 selects; the k are then ordered by (distance,
    index).  Only a row whose k-th and (k+1)-th distances are equal has a
    selection that ties decide: such rows (rare in f32) are selected again
    by `_select_ties`.

    Returns (sqdists [B, M, k] in the inputs' dtype, idx [B, M, k] int64).
    """
    d2 = pairwise_sqdist(query, database)
    if k >= d2.shape[-1]:
        idx = _select_ties(d2, k)
        return torch.gather(d2, -1, idx), idx
    vals, idx = torch.topk(d2, k + 1, dim=-1, largest=False, sorted=True)
    boundary = vals[..., k - 1] == vals[..., k]
    idx, order = torch.sort(idx[..., :k], dim=-1)
    order = torch.sort(torch.gather(vals, -1, order), dim=-1, stable=True).indices
    idx = torch.gather(idx, -1, order)
    if bool(boundary.any()):
        rows = boundary.nonzero(as_tuple=True)
        idx[rows] = _select_ties(d2[rows], k)
    return torch.gather(d2, -1, idx), idx


def _select_ties(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest of each row of `d2` (>= 0) by (distance, index): one
    `topk` on an int64 key, the distance's f32 bits (order-preserving for
    d2 >= 0) above the index; a stable sort for f64."""
    if d2.dtype == torch.float64:   # no room for the index beside f64 bits
        return torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    bits = (d2.float() + 0.0).view(torch.int32).to(torch.int64)   # + 0.0: no -0.0
    key = bits * (1 << 32) + torch.arange(d2.shape[-1], device=d2.device)
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


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


def ball_query(query: torch.Tensor, database: torch.Tensor, radius: float, k: int):
    """The k nearest database points within `radius` of each query point.

    Ascending by distance, equal distances lower index first (as `knn`).
    A row with fewer than k in-radius points repeats its first valid
    neighbour; a row with none gets index 0.  Returns idx [B, M, k] int64
    and mask [B, M, k] bool (True = within radius).
    """
    d2 = pairwise_sqdist(query, database)
    r = torch.tensor(radius, dtype=d2.dtype)
    masked = torch.where(d2 <= r * r, d2, torch.full_like(d2, float('inf')))
    idx = _select_ties(masked, k)
    mask = torch.isfinite(torch.gather(masked, -1, idx))
    first = torch.where(mask[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
    return torch.where(mask, idx, first), mask


def three_nn_interpolate(query: torch.Tensor, database: torch.Tensor,
                         features: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted mean of the features of each query point's
    3 nearest database points: query [B, M, 3], database [B, N, 3],
    features [B, N, C] -> [B, M, C]."""
    d2, idx = knn(query, database, 3)
    w = 1.0 / (d2 + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.einsum('bmk,bmkc->bmc', w, knn_gather(features, idx))
