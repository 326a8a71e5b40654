"""Euler / quaternion / matrix conversions (port of
`pcd_reg_hregnet_tpu/geometry/rotations.py`).

Convention: R = Rx(ax) @ Ry(ay) @ Rz(az), pytorch3d's "XYZ"; quaternions
are (w, x, y, z).  Branches are `torch.where` selections over every
candidate, as in the JAX code.
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


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z), normalised here -> rotation [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> quaternion [..., 4] (w, x, y, z), w >= 0.

    Shepperd's method: all four candidates, the one of the largest
    diagonal discriminant selected (w where the trace is positive, else
    the largest diagonal entry, earlier axes first on ties)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw = safe_sqrt(1.0 + trace) / 2.0
    q_w = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw),
                       (m10 - m01) / (4 * qw)], dim=-1)
    qx = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q_x = torch.stack([(m21 - m12) / (4 * qx), qx, (m01 + m10) / (4 * qx),
                       (m02 + m20) / (4 * qx)], dim=-1)
    qy = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q_y = torch.stack([(m02 - m20) / (4 * qy), (m01 + m10) / (4 * qy), qy,
                       (m12 + m21) / (4 * qy)], dim=-1)
    qz = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q_z = torch.stack([(m10 - m01) / (4 * qz), (m02 + m20) / (4 * qz),
                       (m12 + m21) / (4 * qz), qz], dim=-1)

    cond_w = (trace > 0.0)[..., None]
    cond_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond_y = (m11 >= m22)[..., None]
    q = torch.where(cond_w, q_w, torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angular distance (radians) between unit quaternions [..., 4]."""
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.arccos(torch.clamp(dot, -1.0, 1.0))


def mat2xyzrpy(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] (x, y, z, roll, pitch, yaw)."""
    roll = torch.arctan2(-T[..., 1, 2], T[..., 2, 2])
    pitch = torch.arcsin(torch.clamp(T[..., 0, 2], -1.0, 1.0))
    yaw = torch.arctan2(-T[..., 0, 1], T[..., 0, 0])
    return torch.stack([T[..., 0, 3], T[..., 1, 3], T[..., 2, 3], roll, pitch, yaw], dim=-1)
