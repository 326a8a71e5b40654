"""Overlap-aware circle loss (port of `pcd_reg_hregnet_tpu/losses/circle.py`,
GeoTransformer-style).

The masked logsumexps keep the JAX package's 1e5 offsets and its
stop-gradients on the positive and negative weights; the row and column
means are masked sums, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def overlap_circle_loss(coords_dist: torch.Tensor, feats_dist: torch.Tensor,
                        weights=None, pos_radius: float = 1.5, safe_radius: float = 0.2,
                        log_scale: float = 10.0, pos_optimal: float = 0.1,
                        neg_optimal: float = 1.4, pos_margin: float = 0.1,
                        neg_margin: float = 1.4, epsilon: float = 1e-6) -> torch.Tensor:
    """coords_dist, feats_dist [B, N, k] (kNN spatial / feature distances)
    -> the scalar loss."""
    pos_mask = coords_dist < pos_radius
    neg_mask = coords_dist > safe_radius

    row_sel = (torch.sum(pos_mask, -1) > 0) & (torch.sum(neg_mask, -1) > 0)   # [B,N]
    col_sel = (torch.sum(pos_mask, -2) > 0) & (torch.sum(neg_mask, -2) > 0)   # [B,k]

    pos_w = feats_dist - 1e5 * (~pos_mask).to(feats_dist.dtype)
    pos_w = torch.clamp_min(pos_w - pos_optimal, 0.0).detach()
    neg_w = feats_dist + 1e5 * (~neg_mask).to(feats_dist.dtype)
    neg_w = torch.clamp_min(neg_optimal - neg_w, 0.0).detach()

    feats_dist = torch.clamp(feats_dist, epsilon, 1e6)
    pos = log_scale * (feats_dist - pos_margin) * pos_w
    neg = log_scale * (neg_margin - feats_dist) * neg_w
    loss_row = F.softplus(torch.logsumexp(pos, -1) + torch.logsumexp(neg, -1)) / log_scale
    loss_col = F.softplus(torch.logsumexp(pos, -2) + torch.logsumexp(neg, -2)) / log_scale

    def masked_mean(x, sel):
        s = sel.to(x.dtype)
        return torch.sum(x * s) / (torch.sum(s) + epsilon)

    circle = (masked_mean(loss_row, row_sel) + masked_mean(loss_col, col_sel)) / 2
    if weights is not None:
        w = weights / (torch.sum(weights, dim=-1, keepdim=True) + epsilon)
        circle = torch.sum(circle * w) / (torch.sum(w) + epsilon)
    return circle
