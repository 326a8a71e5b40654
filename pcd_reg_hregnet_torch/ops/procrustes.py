"""Weighted Kabsch pose solve (port of `pcd_reg_hregnet_tpu/ops/procrustes.py`).

Full f32 throughout: the model's forward runs with TF32 off
(`core.device.fp32_numerics`).
A non-finite covariance selects the identity pose, without a branch.
"""
from __future__ import annotations

import torch

_EPS = 1e-4


def weighted_kabsch(src: torch.Tensor, src_corres: torch.Tensor,
                    weights: torch.Tensor):
    """(R [B, 3, 3], t [B, 3]) minimising sum_i w_i ||R src_i + t - corres_i||^2."""
    B = src.shape[0]
    w = weights / (torch.sum(weights, dim=1, keepdim=True) + _EPS)
    wsum = torch.sum(w, dim=1)[:, None, None] + _EPS
    src_mean = torch.einsum('bn,bnc->bc', w, src)[:, None, :] / wsum
    corres_mean = torch.einsum('bn,bnc->bc', w, src_corres)[:, None, :] / wsum

    src_c = src - src_mean
    corres_c = src_corres - corres_mean
    cov = torch.einsum('bni,bnj->bij', src_c * w[..., None], corres_c)

    ok = torch.isfinite(cov).all(dim=2).all(dim=1)              # [B]
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device).expand(B, 3, 3)
    cov_safe = torch.where(ok[:, None, None], cov, eye)

    u, _, vh = torch.linalg.svd(cov_safe)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    d = torch.cat([torch.ones((B, 2), dtype=cov.dtype, device=cov.device),
                   det[:, None]], dim=1)
    R = (v * d[:, None, :]) @ u.transpose(-1, -2)               # v diag(d) u^T
    t = corres_mean[:, 0, :] - torch.einsum('bij,bj->bi', R, src_mean[:, 0, :])

    R = torch.where(ok[:, None, None], R, eye)
    t = torch.where(ok[:, None], t, torch.zeros_like(t))
    return R, t
