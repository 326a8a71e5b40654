"""SO(3) helpers (port of `pcd_reg_hregnet_tpu/geometry/so3.py`, the part
the serving path needs)."""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    row0 = torch.stack([zeros, -wz, wy], dim=-1)
    row1 = torch.stack([wz, zeros, -wx], dim=-1)
    row2 = torch.stack([-wy, wx, zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
