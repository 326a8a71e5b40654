"""SE(3) exponential / logarithm maps and rigid-transform helpers (port of
`pcd_reg_hregnet_tpu/geometry/se3.py`).  Twists are [w, v], w rotational.

All products are full f32: the model's forward runs with TF32 off
(`core.device.fp32_numerics`), the counterpart of the JAX package's
``precision='highest'``.
"""
from __future__ import annotations

import torch

from . import so3


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V(w) = I + sinc2(t) W + sinc3(t) W^2 so that trans = V v."""
    t = so3.safe_norm(w)
    W = so3.hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return I + so3.sinc2(t)[..., None, None] * W + so3.sinc3(t)[..., None, None] * (W @ W)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """V(w)^{-1} in closed form: I - W/2 + (1 - sinc1/(2 sinc2))/t^2 W^2."""
    t = so3.safe_norm(w)
    W = so3.hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    s1, s2 = so3.sinc1(t), so3.sinc2(t)
    t2 = t * t
    coef_exact = (1.0 - s1 / (2.0 * s2)) / torch.where(t2 < 1e-8, torch.ones_like(t2), t2)
    coef_taylor = 1.0 / 12.0 + t2 / 720.0
    coef = torch.where(t < 1e-2, coef_taylor, coef_exact)[..., None, None]
    return I - 0.5 * W + coef * (W @ W)


def exp(x: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] = [w, v] -> homogeneous transform [..., 4, 4]."""
    w, v = x[..., :3], x[..., 3:]
    t = torch.einsum('...ij,...j->...i', _left_jacobian(w), v)
    return pack(so3.exp(w), t)


def log(T: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform [..., 4, 4] -> twist [..., 6] = [w, v]."""
    R, t = unpack(T)
    w = so3.log(R)
    v = torch.einsum('...ij,...j->...i', _left_jacobian_inv(w), t)
    return torch.cat([w, v], dim=-1)


def pack(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def unpack(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3] -> [..., N, 3]."""
    R, t = unpack(T)
    return apply(R, t, points)


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
