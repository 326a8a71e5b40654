"""Euler-angle conversions (port of `pcd_reg_hregnet_tpu/geometry/rotations.py`,
`euler_xyz_to_matrix` and `matrix_to_euler_xyz`).

Convention: R = Rx(ax) @ Ry(ay) @ Rz(az), pytorch3d's "XYZ".
"""
from __future__ import annotations

import torch


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """[..., 3] (ax, ay, az) -> [..., 3, 3] with R = Rx @ Ry @ Rz."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    row0 = torch.stack([cy * cz, -cy * sz, sy], dim=-1)
    row1 = torch.stack([cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy], dim=-1)
    row2 = torch.stack([sx * sz - cx * sy * cz, sx * cz + cx * sy * sz, cx * cy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_xyz(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] inverting R = Rx @ Ry @ Rz."""
    ay = torch.arcsin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    ax = torch.arctan2(-R[..., 1, 2], R[..., 2, 2])
    az = torch.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([ax, ay, az], dim=-1)
