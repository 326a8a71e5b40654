"""Farthest-point sampling and point gathers (port of
`pcd_reg_hregnet_tpu/ops/sampling.py`).

`fps` and `weighted_fps` go to kernel K1/K2 (`ops/kernels/fps.py`) on CUDA
tensors and to its plain loop, `fps_reference`, on CPU tensors.
"""
from __future__ import annotations

import torch

from .kernels.fps import farthest_point_sample, weighted_farthest_point_sample


@torch.no_grad()
def fps(xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """Farthest point sampling: [B, N, 3] -> [B, nsample] int32 indices."""
    return farthest_point_sample(xyz.float().contiguous(), nsample)


@torch.no_grad()
def weighted_fps(xyz: torch.Tensor, weights: torch.Tensor,
                 nsample: int) -> torch.Tensor:
    """Weighted FPS: candidate distances scaled by `weights` [B, N]."""
    return weighted_farthest_point_sample(
        xyz.float().contiguous(), weights.float().contiguous(), nsample)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis: [B, N, C] x [B, M] -> [B, M, C]."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx.long()]
