"""SO(3) exponential / logarithm maps (port of
`pcd_reg_hregnet_tpu/geometry/so3.py`).

The small-angle branches are `torch.where` selections over both forms, as
in the JAX code, so a batch mixes small and ordinary angles freely.
"""
from __future__ import annotations

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
