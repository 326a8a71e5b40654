"""SO(3) exponential / logarithm maps (port of
`pcd_reg_hregnet_tpu/geometry/so3.py`).

The small-angle branches are `torch.where` selections over both forms, as
in the JAX code, so a batch mixes small and ordinary angles freely.
"""
from __future__ import annotations

import math

import torch

_SMALL = 1e-2  # switch to Taylor series below this |theta|


def _safe(t: torch.Tensor) -> torch.Tensor:
    """Near-zero values replaced by 1, so that divisions stay finite; the
    quotient is only used where |t| >= _SMALL."""
    return torch.where(torch.abs(t) < _SMALL, torch.ones_like(t), t)


def safe_norm(w: torch.Tensor) -> torch.Tensor:
    """||w|| along the last axis, finite gradient at w = 0."""
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def sinc1(t: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with Taylor fallback."""
    t2 = t * t
    taylor = 1.0 - t2 / 6.0 * (1.0 - t2 / 20.0 * (1.0 - t2 / 42.0))
    exact = torch.sin(_safe(t)) / _safe(t)
    return torch.where(torch.abs(t) < _SMALL, taylor, exact)


def sinc2(t: torch.Tensor) -> torch.Tensor:
    """(1 - cos(t))/t^2 with Taylor fallback."""
    t2 = t * t
    taylor = 1.0 / 2.0 * (1.0 - t2 / 12.0 * (1.0 - t2 / 30.0 * (1.0 - t2 / 56.0)))
    exact = (1.0 - torch.cos(_safe(t))) / (_safe(t) ** 2)
    return torch.where(torch.abs(t) < _SMALL, taylor, exact)


def sinc3(t: torch.Tensor) -> torch.Tensor:
    """(t - sin(t))/t^3 with Taylor fallback."""
    t2 = t * t
    taylor = 1.0 / 6.0 * (1.0 - t2 / 20.0 * (1.0 - t2 / 42.0 * (1.0 - t2 / 72.0)))
    s = _safe(t)
    exact = (s - torch.sin(s)) / (s ** 3)
    return torch.where(torch.abs(t) < _SMALL, taylor, exact)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    row0 = torch.stack([zeros, -wz, wy], dim=-1)
    row1 = torch.stack([wz, zeros, -wx], dim=-1)
    row2 = torch.stack([-wy, wx, zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation [..., 3, 3],
    R = I + sinc1(t) W + sinc2(t) W^2."""
    t = safe_norm(w)
    W = hat(w)
    I = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return I + sinc1(t)[..., None, None] * W + sinc2(t)[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3]: theta from the trace,
    vee of the skew part divided by sinc1(theta)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    skew = 0.5 * (R - R.transpose(-1, -2))
    return vee(skew) / sinc1(theta)[..., None]


def transform(R: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply rotation(s) to points: [..., 3, 3] x [..., N, 3] -> [..., N, 3],
    an elementwise product and sum in the inputs' dtype (never TF32, as the
    JAX package's `precision='highest'`)."""
    return torch.sum(R[..., None, :, :] * points[..., :, None, :], dim=-1)


def inverse(R: torch.Tensor) -> torch.Tensor:
    return R.transpose(-1, -2)


def geodesic_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle of R1^T R2 in radians, per batch element.

    atan2(sin, cos), sin from the skew part, cos from the trace: the JAX
    package's arccos of the clipped trace loses ~sqrt(eps) of f32 near the
    identity (~1e-4 rad), where this keeps ~1e-7, as `eval.calib_eval`'s
    error angle does; elsewhere the two agree to f32 round-off."""
    M = torch.matmul(R1.transpose(-1, -2), R2)
    trace = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    skew = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                        M[..., 1, 0] - M[..., 0, 1]], dim=-1)
    return torch.arctan2(0.5 * torch.linalg.norm(skew, dim=-1), cos_t)


def random_rotation(gen: torch.Generator, batch_shape: tuple = ()) -> torch.Tensor:
    """Random rotations [*batch_shape, 3, 3] (f32, CPU): a normal axis turned
    by an angle uniform in [0, pi), drawn from `gen`."""
    batch_shape = tuple(batch_shape)
    axis = torch.randn(batch_shape + (3,), generator=gen)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
    angle = torch.rand(batch_shape + (1,), generator=gen) * math.pi
    return exp(axis * angle)
