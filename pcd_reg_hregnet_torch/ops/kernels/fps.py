"""Farthest-point sampling: CUDA kernel K1/K2 and its plain version.

Replaces `pcd_reg_hregnet_tpu/ops/pallas/fps.py::_fps_kernel` (K1 with
``weighted=False``, K2 with ``weighted=True``); the kernel is
`csrc/fps.cu`.  Semantics are `_fps_impl`'s (`ops/sampling.py`): first
index 0, running min squared distance initialised to 1e10, argmax with
first-index tie-break, weighted candidates scaled by their own weight.
The kernel splits a row over a thread-block cluster of up to 8 CTAs; the
wrapper picks the block shape from N (`choose_config`).  Rows above 65536
points take the global-memory variant, whose points and running distances
stay in device memory (any N).
"""
from __future__ import annotations

from typing import Optional

import torch

_INIT_DIST = 1e10

# (threads per CTA, points per thread, CTAs per row in a cluster); a
# configuration's id is its position, and `csrc/fps.cu::kConfigs` holds the
# same table.  A row of N points needs threads * points * CTAs >= N.
CONFIGS = (
    (1024, 8, 1), (1024, 1, 1), (512, 16, 1), (512, 8, 2), (256, 8, 4),
    (128, 8, 8), (128, 4, 4), (128, 8, 4), (256, 8, 8), (256, 16, 8),
    (512, 16, 8), (32, 32, 1), (32, 16, 1), (64, 8, 1), (128, 8, 1),
    (128, 4, 1), (256, 4, 1), (256, 8, 1),
)
# (largest N, configuration id) in increasing N: the chooser's table, the
# fastest configuration at each band's N in `chip_smoke.py`'s sweep on an
# H100 (PERF.md).
BANDS = ((512, 15), (1024, 14), (2048, 17), (4096, 7), (8192, 5),
         (16384, 8), (32768, 9), (65536, 10))
# The id of the global-memory variant (`csrc/fps.cu`: 1024 threads, 8 CTAs
# per row, points and running distances in device memory), for any N above
# the bands.
GLOBAL_MEMORY = len(CONFIGS)
MAX_INT32 = 2 ** 31 - 1


def capacity(config: int) -> int:
    """The most points a row may hold in configuration `config`."""
    if config == GLOBAL_MEMORY:
        return MAX_INT32
    threads, ppt, cluster = CONFIGS[config]
    return threads * ppt * cluster


def choose_config(n: int) -> int:
    """The configuration id the wrappers launch for rows of `n` points."""
    for max_n, config in BANDS:
        if n <= max_n:
            return config
    return GLOBAL_MEMORY


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


def _check(xyz: torch.Tensor, weights: Optional[torch.Tensor], nsample: int,
           config: Optional[int]) -> int:
    """Validate a launch's arguments; returns the configuration id."""
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f'fps kernel takes f32 [B, N, 3], got '
                         f'{xyz.dtype} {tuple(xyz.shape)}')
    if not xyz.is_contiguous():
        raise ValueError('fps kernel takes a contiguous xyz')
    B, N, _ = xyz.shape
    if not 1 <= nsample <= N <= MAX_INT32:
        raise ValueError(f'fps kernel needs 1 <= nsample <= N <= {MAX_INT32}, '
                         f'got nsample={nsample}, N={N}')
    if weights is not None:
        if (weights.dtype != torch.float32 or tuple(weights.shape) != (B, N)
                or weights.device != xyz.device or not weights.is_contiguous()):
            raise ValueError(f'fps kernel takes contiguous f32 weights [{B}, {N}] '
                             f'on {xyz.device}, got {weights.dtype} '
                             f'{tuple(weights.shape)} on {weights.device}')
    if config is None:
        return choose_config(N)
    if not 0 <= config <= GLOBAL_MEMORY or capacity(config) < N:
        raise ValueError(f'fps configuration {config} cannot hold N={N}')
    return config


def _launch(xyz: torch.Tensor, weights: Optional[torch.Tensor],
            nsample: int, config: Optional[int] = None) -> torch.Tensor:
    """Launch K1 (`weights` None) or K2 in configuration `config` (the
    chooser's by default); counts nothing."""
    from .build import library
    config = _check(xyz, weights, nsample, config)
    B, N, _ = xyz.shape
    out = torch.empty((B, nsample), dtype=torch.int32, device=xyz.device)
    dist = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
            if config == GLOBAL_MEMORY else None)
    lib = library()
    with torch.cuda.device(xyz.device):
        err = lib.lib.pcdreg_fps(
            xyz.data_ptr(), None if weights is None else weights.data_ptr(),
            None if dist is None else dist.data_ptr(), out.data_ptr(), B, N, nsample, config,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    lib.check(err, 'pcdreg_fps')
    return out


def probe(xyz: torch.Tensor, nsample: int,
          config: Optional[int] = None) -> torch.Tensor:
    """Launch the latency probe of `csrc/fps.cu`: the kernel's nsample-1
    steps of reduction and synchronisation in configuration `config`, with
    no distance update.  Its time is the floor of one FPS call of that
    configuration; its output is not FPS indices."""
    from .build import library
    config = _check(xyz, None, nsample, config)
    if config == GLOBAL_MEMORY:
        raise ValueError('the fps probe has no global-memory variant')
    B, N, _ = xyz.shape
    out = torch.empty((B, nsample), dtype=torch.int32, device=xyz.device)
    lib = library()
    with torch.cuda.device(xyz.device):
        err = lib.lib.pcdreg_fps_probe(
            xyz.data_ptr(), out.data_ptr(), B, N, nsample, config,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    lib.check(err, 'pcdreg_fps_probe')
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
