"""Rigid-transform helpers (port of `pcd_reg_hregnet_tpu/geometry/se3.py`
`pack`/`unpack`/`apply`/`compose`/`inverse`).

All products are full f32: the model's forward runs with TF32 off
(`core.device.fp32_numerics`), the counterpart of the JAX package's
``precision='highest'``.
"""
from __future__ import annotations

import torch


def pack(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def unpack(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def apply(R: torch.Tensor, t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points [..., N, 3]."""
    return torch.einsum('...ij,...nj->...ni', R, points) + t[..., None, :]


def inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = unpack(T)
    Rinv = R.transpose(-1, -2)
    tinv = -torch.einsum('...ij,...j->...i', Rinv, t)
    return pack(Rinv, tinv)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb (apply Tb first, then Ta)."""
    return torch.matmul(Ta, Tb)
