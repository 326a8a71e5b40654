"""ICP refinement on the device, point-to-point and point-to-plane (port of
`pcd_reg_hregnet_tpu/eval/icp.py`).

Fixed-iteration solvers: each iteration is one exact nearest-neighbour
search over the dense distance matrix and a closed-form update.  The
correspondence threshold anneals geometrically from `threshold` to
`threshold_end`, and a per-item trust test keeps the refined pose only
where its truncated residual at `threshold_end` is less than
`TRUST_MARGIN` times the initial pose's: ICP may rescue a failed pose but
not drift a converged one to its own biased optimum.  Everything runs in
f32 with TF32 off.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import fp32_numerics
from ..geometry import se3
from ..ops.neighbors import knn, knn_gather, pairwise_sqdist
from ..ops.procrustes import weighted_kabsch
from ..ops.sampling import gather_points

TRUST_MARGIN = 0.5
# Query rows per distance block in `_nn`: bounds the [B, rows, N] block
# (B=8, N=8096: 0.5 GB f32 at 2048 rows; the whole matrix is 2.1 GB).
NN_ROWS = 2048
# 3x3 matrices per `torch.linalg.eigh` call: the batched cuSOLVER eigensolver
# that torch 2.11 with CUDA 12.8 calls takes 16384 and refuses 32767 or more
# (CUSOLVER_STATUS_INVALID_VALUE on an H100, `tools/probe_eigh.py`); B=8 x
# 8096 normals are 64768.
EIGH_BATCH = 16384


def _nn(src: torch.Tensor, dst: torch.Tensor):
    """Nearest neighbour of each src point in dst: (sqdist [B, N], idx [B, N])."""
    d2s, idxs = [], []
    for start in range(0, src.shape[1], NN_ROWS):
        d2, idx = torch.min(pairwise_sqdist(src[:, start:start + NN_ROWS], dst), dim=-1)
        d2s.append(d2)
        idxs.append(idx)
    return torch.cat(d2s, dim=1), torch.cat(idxs, dim=1)


def _sq(threshold) -> float:
    """threshold^2 computed in f32, as the JAX code squares its f32 argument."""
    thr = torch.as_tensor(threshold, dtype=torch.float32)
    return float(thr * thr)


def _anneal(threshold: float, threshold_end: float, i: int, max_iters: int) -> torch.Tensor:
    """Geometric schedule, in f32 as in the JAX code: `threshold` at i=0,
    `threshold_end` at the last iteration."""
    f32 = torch.float32
    frac = torch.tensor(i, dtype=f32) / max(1, max_iters - 1)
    thr0 = torch.tensor(threshold, dtype=f32)
    return thr0 * (torch.tensor(threshold_end, dtype=f32) / thr0) ** frac


def truncated_residual(src: torch.Tensor, dst: torch.Tensor, T: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """Per-item truncated NN residual mean(min(d2, thr^2)) [B] (lower is better)."""
    d2, _ = _nn(se3.transform(T, src), dst)
    return torch.mean(torch.clamp_max(d2, _sq(threshold)), dim=-1)


def _trust_select(src, dst, init_T, refined_T, threshold_end, trust_margin=None):
    """The refined pose where it scores better than `margin` times the
    initial one's residual, else the initial pose (per batch item)."""
    margin = TRUST_MARGIN if trust_margin is None else trust_margin
    r_init = truncated_residual(src, dst, init_T, threshold_end)
    r_ref = truncated_residual(src, dst, refined_T, threshold_end)
    better = (r_ref < margin * r_init)[:, None, None]
    return torch.where(better, refined_T, init_T)


def _inlier_weights(d2: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """1 inside the threshold, 0 outside; all ones for an item with none."""
    w = (d2 < _sq(thr)).to(d2.dtype)
    any_w = torch.sum(w, dim=1, keepdim=True) > 0
    return torch.where(any_w, w, torch.ones_like(w))


@torch.no_grad()
@fp32_numerics()
def icp_point_to_point(src: torch.Tensor, dst: torch.Tensor, init_T: torch.Tensor,
                       threshold: float = 1.0, max_iters: int = 30,
                       threshold_end: float = 0.1,
                       trust_margin: Optional[float] = None) -> torch.Tensor:
    """Point-to-point ICP.  src/dst [B, N, 3]; init_T [B, 4, 4] -> [B, 4, 4]."""
    T = init_T
    for i in range(max_iters):
        thr = _anneal(threshold, threshold_end, i, max_iters)
        cur = se3.transform(T, src)
        d2, idx = _nn(cur, dst)
        R, t = weighted_kabsch(cur, gather_points(dst, idx), _inlier_weights(d2, thr))
        T = se3.compose(se3.pack(R, t), T)
    return _trust_select(src, dst, init_T, T, threshold_end, trust_margin)


@torch.no_grad()
@fp32_numerics()
def estimate_normals(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Per-point normals [B, N, 3]: the eigenvector of the smallest
    eigenvalue of the exact kNN covariance (the sign is whatever the
    eigen-solver gives; point-to-plane ICP does not depend on it)."""
    nbrs = torch.cat([knn_gather(points, knn(points[:, s:s + NN_ROWS], points, k)[1])
                      for s in range(0, points.shape[1], NN_ROWS)], dim=1)
    centered = nbrs - torch.mean(nbrs, dim=2, keepdim=True)
    cov = torch.einsum('bnki,bnkj->bnij', centered, centered) / k
    vecs = torch.cat([torch.linalg.eigh(c)[1] for c in cov.reshape(-1, 3, 3).split(EIGH_BATCH)])
    return vecs[..., 0].reshape(points.shape)


@torch.no_grad()
@fp32_numerics()
def icp_point_to_plane(src: torch.Tensor, dst: torch.Tensor, dst_normals: torch.Tensor,
                       init_T: torch.Tensor, threshold: float = 1.0,
                       max_iters: int = 30, threshold_end: float = 0.1,
                       trust_margin: Optional[float] = None) -> torch.Tensor:
    """Point-to-plane ICP through the linearised normal equations: each
    step solves min_x sum_i w_i (J_i x + r_i)^2, J_i = [p_i x n_i, n_i],
    for the twist x = [w, v] (a 6x6 solve), clamped to norm 1."""
    eye6 = 1e-6 * torch.eye(6, dtype=src.dtype, device=src.device)
    qn_all = torch.cat([dst, dst_normals], dim=-1)
    T = init_T
    for i in range(max_iters):
        thr = _anneal(threshold, threshold_end, i, max_iters)
        cur = se3.transform(T, src)
        d2, idx = _nn(cur, dst)
        qn = gather_points(qn_all, idx)
        q, n = qn[..., :3], qn[..., 3:]
        w = _inlier_weights(d2, thr)
        r = torch.sum((cur - q) * n, dim=-1)                             # [B, N]
        J = torch.cat([torch.cross(cur, n, dim=-1), n], dim=-1)          # [B, N, 6]
        JTJ = torch.einsum('bn,bni,bnj->bij', w, J, J) + eye6
        JTr = torch.einsum('bn,bni,bn->bi', w, J, r)
        x = -torch.linalg.solve(JTJ, JTr[..., None])[..., 0]             # [B, 6]
        norm = torch.linalg.norm(x, dim=-1, keepdim=True)
        x = x * torch.clamp_max(1.0 / (norm + 1e-12), 1.0)
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        T = se3.compose(se3.exp(x), T)
    return _trust_select(src, dst, init_T, T, threshold_end, trust_margin)


def refine(src: torch.Tensor, dst: torch.Tensor, init_T: torch.Tensor,
           method: str = 'point_to_point', threshold: float = 1.0,
           max_iters: int = 30, threshold_end: float = 0.1,
           trust_margin: Optional[float] = None) -> torch.Tensor:
    """ICP refinement of `init_T` by `method`."""
    if method == 'point_to_point':
        return icp_point_to_point(src, dst, init_T, threshold, max_iters,
                                  threshold_end, trust_margin)
    if method == 'point_to_plane':
        return icp_point_to_plane(src, dst, estimate_normals(dst), init_T, threshold,
                                  max_iters, threshold_end, trust_margin)
    raise ValueError(f'unknown ICP method {method!r}')
