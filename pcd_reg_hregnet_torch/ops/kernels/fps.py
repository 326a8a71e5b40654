"""Farthest-point sampling: CUDA kernel K1/K2 and its plain version.

Replaces `pcd_reg_hregnet_tpu/ops/pallas/fps.py::_fps_kernel` (K1 with
``weighted=False``, K2 with ``weighted=True``); the kernel is
`csrc/fps.cu`.  Semantics are `_fps_impl`'s (`ops/sampling.py`): first
index 0, running min squared distance initialised to 1e10, argmax with
first-index tie-break, weighted candidates scaled by their own weight.
"""
from __future__ import annotations

from typing import Optional

import torch

_INIT_DIST = 1e10
MAX_POINTS = 16384   # 1024 threads x 16 points held in registers


def fps_reference(xyz: torch.Tensor, weights: Optional[torch.Tensor],
                  nsample: int) -> torch.Tensor:
    """Plain PyTorch FPS loop: [B, N, 3] (+ [B, N]) -> [B, nsample] int32."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    temp = torch.full((B, N), _INIT_DIST, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((B, nsample), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for j in range(1, nsample):
        p = xyz[rows, last]                                   # [B, 3]
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        if weights is not None:
            d = d * weights
        temp = torch.minimum(temp, d)
        last = torch.argmax(temp, dim=-1)
        idx[:, j] = last
    return idx.to(torch.int32)


def _launch(xyz: torch.Tensor, weights: Optional[torch.Tensor],
            nsample: int) -> torch.Tensor:
    from .build import library
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f'fps kernel takes f32 [B, N, 3], got '
                         f'{xyz.dtype} {tuple(xyz.shape)}')
    if not xyz.is_contiguous():
        raise ValueError('fps kernel takes a contiguous xyz')
    B, N, _ = xyz.shape
    if not 1 <= nsample <= N or N > MAX_POINTS:
        raise ValueError(f'fps kernel needs 1 <= nsample <= N <= {MAX_POINTS}, '
                         f'got nsample={nsample}, N={N}')
    if weights is not None:
        if (weights.dtype != torch.float32 or tuple(weights.shape) != (B, N)
                or weights.device != xyz.device or not weights.is_contiguous()):
            raise ValueError(f'fps kernel takes contiguous f32 weights [{B}, {N}] '
                             f'on {xyz.device}, got {weights.dtype} '
                             f'{tuple(weights.shape)} on {weights.device}')
    out = torch.empty((B, nsample), dtype=torch.int32, device=xyz.device)
    lib = library()
    with torch.cuda.device(xyz.device):
        err = lib.lib.pcdreg_fps(
            xyz.data_ptr(), None if weights is None else weights.data_ptr(),
            out.data_ptr(), B, N, nsample,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    lib.check(err, 'pcdreg_fps')
    return out


def farthest_point_sample(xyz: torch.Tensor, nsample: int) -> torch.Tensor:
    """FPS [B, N, 3] -> [B, nsample] int32: kernel K1 on CUDA tensors, the
    plain version on CPU tensors."""
    if xyz.device.type == 'cpu':
        return fps_reference(xyz, None, nsample)
    if xyz.device.type != 'cuda':
        raise ValueError(f'fps: unsupported device {xyz.device}')
    out = _launch(xyz, None, nsample)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0


def weighted_farthest_point_sample(xyz: torch.Tensor, weights: torch.Tensor,
                                   nsample: int) -> torch.Tensor:
    """Weighted FPS: kernel K2 on CUDA tensors, the plain version on CPU."""
    if xyz.device.type == 'cpu' and weights.device.type == 'cpu':
        return fps_reference(xyz, weights, nsample)
    if xyz.device.type != 'cuda':
        raise ValueError(f'weighted fps: unsupported device {xyz.device}')
    out = _launch(xyz, weights, nsample)
    weighted_farthest_point_sample.launches += 1
    return out


weighted_farthest_point_sample.launches = 0
