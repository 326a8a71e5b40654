"""Camera projection: point clouds to image pixels and batched depth images
(port of `pcd_reg_hregnet_tpu/data/projection.py`).

The host helpers are numpy.  `render_depth_images` is torch on the
clouds' device: one scatter for the whole batch, each pixel taking the
point nearest the camera (smallest depth; equal depths, the lower index).
The JAX package's `.at[].set` keeps an unspecified one of the points that
fall on a pixel; elsewhere the two images are equal.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..geometry import se3


def _pixels(img_shape: Tuple[int, int], intrinsic: np.ndarray, pcd: np.ndarray):
    H, W = img_shape
    proj = pcd @ np.asarray(intrinsic).T
    with np.errstate(divide='ignore', invalid='ignore'):
        u = (proj[:, 0] / proj[:, 2]).astype(np.int64)
        v = (proj[:, 1] / proj[:, 2]).astype(np.int64)
    valid = (0 <= u) & (u < W) & (0 <= v) & (v < H) & (proj[:, 2] > 0)
    return u, v, valid


def project_to_image(img_shape: Tuple[int, int], intrinsic: np.ndarray,
                     pcd: np.ndarray, range_arr: np.ndarray):
    """Project points [N, 3] through a 3x3 intrinsic onto an (H, W) image.

    Returns (u, v, r, valid): the integer pixel coordinates (truncated
    toward zero) and ranges of the in-bounds points in front of the camera,
    and the full-length valid mask."""
    u, v, valid = _pixels(img_shape, intrinsic, pcd)
    return u[valid], v[valid], np.asarray(range_arr)[valid], valid


def binary_projection(img_shape: Tuple[int, int], intrinsic: np.ndarray, pcd: np.ndarray):
    """`project_to_image`'s (u, v, valid), unfiltered."""
    return _pixels(img_shape, intrinsic, pcd)


def azimuth_filter(points: np.ndarray, min_deg: float = -130.0,
                   max_deg: float = 50.0) -> np.ndarray:
    """Keep the points whose xy azimuth lies in [min_deg, max_deg] (the
    reference's forward camera sector by default)."""
    theta = np.degrees(np.arctan2(points[:, 1], points[:, 0]))
    return points[(theta >= min_deg) & (theta <= max_deg)]


def render_depth_images(extrinsic: torch.Tensor, pcd: torch.Tensor, intrinsic: torch.Tensor,
                        img_shape: Tuple[int, int], pcd_range: torch.Tensor,
                        intensity: torch.Tensor,
                        density: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched clouds -> 3-channel (range, intensity, density) depth images.

    Points [B, N, 3] are moved by extrinsics [B, 4, 4], projected through
    the 3x3 intrinsic (pixel coordinates truncated toward zero), and each
    in-bounds point in front of the camera writes its channels to its
    pixel; where several share one, the nearest (smallest depth, then the
    lower index) wins.  Returns (depth_img [B, 3, H, W], moved clouds
    [B, N, 3])."""
    H, W = img_shape
    B, N, _ = pcd.shape
    p = se3.transform(extrinsic, pcd)
    proj = torch.einsum('ij,bnj->bni', intrinsic, p)
    w = proj[..., 2]
    u = (proj[..., 0] / w).to(torch.int64)
    v = (proj[..., 1] / w).to(torch.int64)
    valid = (0 <= u) & (u < W) & (0 <= v) & (v < H) & (w > 0)
    # one scratch pixel per cloud past H * W takes the invalid points
    pixel = torch.where(valid, v * W + u, H * W) + (H * W + 1) * torch.arange(
        B, device=pcd.device)[:, None]
    pixel, depth = pixel.reshape(-1), torch.where(valid, w, torch.inf).reshape(-1)
    nearest = torch.full((B * (H * W + 1),), torch.inf, dtype=w.dtype, device=w.device)
    nearest.scatter_reduce_(0, pixel, depth, 'amin')
    index = torch.arange(B * N, device=pcd.device)
    first = torch.full_like(nearest, B * N, dtype=torch.int64)
    first.scatter_reduce_(0, pixel, torch.where(depth == nearest[pixel], index, B * N), 'amin')
    values = torch.stack([pcd_range, intensity, density], dim=-1).reshape(B * N, 3)
    hit = first < B * N
    img = torch.zeros((B * (H * W + 1), 3), dtype=values.dtype, device=values.device)
    img[hit] = values[first[hit]]
    img = img.reshape(B, H * W + 1, 3)[:, : H * W]
    return img.reshape(B, H, W, 3).permute(0, 3, 1, 2), p


class DepthImageRenderer:
    """`render_depth_images` with the image shape, the intrinsic (its
    top-left 3x3) and the per-point channels bound once, the extrinsic
    varying per call."""

    def __init__(self, img_shape: Tuple[int, int], intrinsic, pcd_range: torch.Tensor,
                 intensity: torch.Tensor, density: torch.Tensor):
        intrinsic = torch.as_tensor(np.asarray(intrinsic), dtype=torch.float32)
        K = torch.eye(3)
        K[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic[:3, :3]
        self.img_shape = tuple(img_shape)
        self.intrinsic = K.to(pcd_range.device)
        self.pcd_range, self.intensity, self.density = pcd_range, intensity, density

    def __call__(self, extrinsic: torch.Tensor, pcd: torch.Tensor):
        return render_depth_images(extrinsic, pcd, self.intrinsic, self.img_shape,
                                   self.pcd_range, self.intensity, self.density)
