"""Pose loss and error metrics (port of
`pcd_reg_hregnet_tpu/losses/losses.py`: `transformation_loss`,
`rotation_errors`, `translation_errors`).

The 3x3 products R_pred^T R_gt are written out as elementwise sums, so they
are full f32 whatever the matmul precision flags say (the JAX package's
``precision='highest'``): near the identity a reduced-precision product
shows up directly as rotation error.
"""
from __future__ import annotations

import torch

from ..geometry.rotations import matrix_to_euler_xyz


def _relative_rotation(pred_R: torch.Tensor, gt_R: torch.Tensor) -> torch.Tensor:
    """R_pred^T R_gt [B, 3, 3] in full f32."""
    return torch.sum(pred_R[..., :, :, None] * gt_R[..., :, None, :], dim=-3)


def transformation_loss(pred_R: torch.Tensor, pred_t: torch.Tensor, gt_R: torch.Tensor,
                        gt_t: torch.Tensor, alpha: float = 1.0) -> dict:
    """Pose loss + error metrics: loss = alpha * mean ||R_pred^T R_gt - I||_F
    + mean ||t_pred - t_gt||.  Returns loss, loss_R, loss_t, per-axis
    rotation error rot_err [3] (deg, mean over the batch), geodesic rre [B]
    (deg), per-axis translation error trans_err [3] (m) and rte [B] (m)."""
    R_rel = _relative_rotation(pred_R, gt_R)
    eye = torch.eye(3, dtype=pred_R.dtype, device=pred_R.device)
    resi_R = torch.linalg.norm((R_rel - eye).reshape(pred_R.shape[0], -1), dim=-1)
    R_err_deg, geodesic = rotation_errors(pred_R, gt_R)
    T_err, eucl = translation_errors(pred_t, gt_t)
    loss_R = torch.mean(resi_R)
    loss_t = torch.mean(eucl)
    return dict(loss=alpha * loss_R + loss_t, loss_R=loss_R, loss_t=loss_t,
                rot_err=R_err_deg, rre=geodesic, trans_err=T_err, rte=eucl)


def rotation_errors(pred_R: torch.Tensor, gt_R: torch.Tensor):
    """Per-axis Euler error [3] (deg, mean over the batch) and the geodesic
    RRE [B] (deg) by atan2, well conditioned near the identity where
    arccos((trace - 1) / 2) loses ~sqrt(eps)."""
    R_rel = _relative_rotation(pred_R, gt_R)
    R_err_deg = torch.mean(torch.abs(torch.rad2deg(matrix_to_euler_xyz(R_rel))), dim=0)
    trace = R_rel[..., 0, 0] + R_rel[..., 1, 1] + R_rel[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    skew = torch.stack([R_rel[..., 2, 1] - R_rel[..., 1, 2],
                        R_rel[..., 0, 2] - R_rel[..., 2, 0],
                        R_rel[..., 1, 0] - R_rel[..., 0, 1]], dim=-1)
    sin_t = 0.5 * torch.linalg.norm(skew, dim=-1)
    return R_err_deg, torch.rad2deg(torch.arctan2(sin_t, cos_t))


def translation_errors(pred_t: torch.Tensor, gt_t: torch.Tensor):
    """Per-axis MAE [3] (m) and the Euclidean RTE [B] (m)."""
    err = pred_t - gt_t
    return torch.mean(torch.abs(err), dim=0), torch.linalg.norm(err, dim=-1)
