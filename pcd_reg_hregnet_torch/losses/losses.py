"""Core registration losses (port of `pcd_reg_hregnet_tpu/losses/losses.py`):
the feats pretrain's probabilistic chamfer and matching losses, the pose
loss and its error metrics.

The 3x3 products R_pred^T R_gt are written out as elementwise sums, so they
are full f32 whatever the matmul precision flags say (the JAX package's
``precision='highest'``): near the identity a reduced-precision product
shows up directly as rotation error.  The distance matrices and the soft
correspondences are matmuls: they are exact f32 only with TF32 off, as in
the objectives' forward (`core.device.fp32_numerics`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..geometry import se3
from ..geometry.rotations import matrix_to_euler_xyz
from ..ops.neighbors import pairwise_sqdist


def _pair_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix [B, M, N] between [B, M, C] and [B, N, C]."""
    return torch.sqrt(pairwise_sqdist(a, b) + 1e-12)


def _nearest(diff: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, first argmin) of `diff` along `dim`; the gradient reaches the
    argmin entry alone, as `jnp.min`'s does where the minimum is unique."""
    idx = torch.argmin(diff, dim=dim, keepdim=True)
    return torch.take_along_dim(diff, idx, dim=dim).squeeze(dim), idx.squeeze(dim)


def prob_chamfer_loss(keypoints1: torch.Tensor, keypoints2: torch.Tensor,
                      sigma1: Optional[torch.Tensor], sigma2: Optional[torch.Tensor],
                      gt_R: torch.Tensor, gt_t: torch.Tensor) -> torch.Tensor:
    """Sigma-weighted bidirectional nearest-neighbour loss of keypoints1
    moved by (gt_R, gt_t) against keypoints2, the detector's training
    signal: keypoints [B, M, 3], sigma [B, M] (None: the plain mean of the
    nearest distances both ways)."""
    diff = _pair_dist(se3.apply(gt_R, gt_t, keypoints1), keypoints2)     # [B,M,N]
    if sigma1 is None or sigma2 is None:
        return torch.amin(diff, dim=2).mean() + torch.amin(diff, dim=1).mean()
    min_f, idx_f = _nearest(diff, 2)
    sigma_f = (sigma1 + torch.gather(sigma2, 1, idx_f)) / 2
    fwd = (torch.log(sigma_f) + min_f / sigma_f).mean()
    min_b, idx_b = _nearest(diff, 1)
    sigma_b = (sigma2 + torch.gather(sigma1, 1, idx_b)) / 2
    bwd = (torch.log(sigma_b) + min_b / sigma_b).mean()
    return fwd + bwd


def conf_weights(sigma: torch.Tensor, sigma_max: float = 3.0) -> torch.Tensor:
    """Per-keypoint confidence max(sigma_max - sigma, 0.01), mean-normalised
    per row; detached (the JAX package's `stop_gradient`)."""
    w = torch.clamp(sigma_max - sigma, min=0.01)
    return (w / torch.mean(w, dim=1, keepdim=True)).detach()


def matching_loss(src_kp: torch.Tensor, src_sigma: torch.Tensor, src_desc: torch.Tensor,
                  dst_kp: torch.Tensor, dst_sigma: torch.Tensor, dst_desc: torch.Tensor,
                  gt_R: torch.Tensor, gt_t: torch.Tensor, temp: float = 0.1,
                  sigma_max: float = 3.0) -> torch.Tensor:
    """Soft-correspondence descriptor loss: each keypoint's correspondence is
    the softmax-weighted mean of the other cloud's keypoints over
    1/(descriptor distance + 1e-3)/temp; its distance from the keypoint
    (src moved by the ground truth) weighted by `conf_weights`, both ways.
    desc [B, M, C] channels-last."""
    src_kp = se3.apply(gt_R, gt_t, src_kp)
    inv = (1.0 / (_pair_dist(src_desc, dst_desc) + 1e-3)) / temp          # [B,M,N]
    score_src = torch.softmax(inv, dim=2)                                 # over dst
    score_dst = torch.softmax(inv, dim=1).transpose(1, 2)                 # over src
    dt = torch.promote_types(score_src.dtype, dst_kp.dtype)   # bf16 scores meet f32 xyz
    src_corres = torch.bmm(score_src.to(dt), dst_kp.to(dt))
    dst_corres = torch.bmm(score_dst.to(dt), src_kp.to(dt))
    diff_f = torch.linalg.norm(src_kp - src_corres, dim=-1)
    diff_b = torch.linalg.norm(dst_kp - dst_corres, dim=-1)
    loss_f = (conf_weights(src_sigma, sigma_max) * diff_f).mean()
    loss_b = (conf_weights(dst_sigma, sigma_max) * diff_b).mean()
    return loss_f + loss_b


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
