"""Serving entry points (port of `pcd_reg_hregnet_tpu/eval/runner.py::infer_pair`).

`register` runs the network on fixed-size batches already on the caller's
side; `infer_pair` takes raw clouds of any length, range-filters and
resamples them to the model's input size, and returns the finest pose,
optionally refined by ICP.  Both run on the card unless the caller passes
``device='cpu'``.  They take any model the zoo builds; trained weights:
``zoo.build('model_v6', weights=utils.checkpoint.FLAGSHIP)`` (reg_v11),
``zoo.build('model_v2', weights=utils.checkpoint.A1)`` (reg_v6), or any
train checkpoint directory the port wrote,
``zoo.build('model_v6', weights='runs/torch/ckpt/best_rre')``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.config import DataConfig
from .core.device import resolve_device
from .data.pipeline import range_filter, resample
from .eval.icp import refine
from .geometry import se3


@torch.no_grad()
def register(model: torch.nn.Module, src: torch.Tensor | np.ndarray,
             dst: torch.Tensor | np.ndarray, *,
             device: str | torch.device = 'cuda') -> dict:
    """Register a batch: src, dst [B, N, 3] -> finest pose.

    Returns {'rotation': [B, 3, 3], 'translation': [B, 3], 'weights': [B, n]}
    as tensors on `device`: the finest level's pose and its correspondence
    weights (`src_dst_weights_1`).
    """
    dev = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f'model is on {param.device}, register was asked for {dev}')
    src = torch.as_tensor(src, dtype=torch.float32, device=param.device)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=param.device)
    if src.dim() != 3 or src.shape[-1] != 3 or src.shape != dst.shape:
        raise ValueError(f'register takes src, dst [B, N, 3] of one shape, got '
                         f'{tuple(src.shape)} and {tuple(dst.shape)}')
    out = model(src, dst)
    return {'rotation': out['rotation'][-1], 'translation': out['translation'][-1],
            'weights': out['src_dst_weights_1']}


def infer_pair(model: torch.nn.Module, src_points: np.ndarray,
               dst_points: np.ndarray, *, device: str | torch.device = 'cuda',
               max_range: Optional[float] = None, num_points: Optional[int] = None,
               icp: Optional[str] = None, icp_threshold: float = 1.0,
               icp_iters: int = 30) -> dict:
    """Register ONE raw source cloud onto one raw target cloud.

    Clouds [n, >=3] of any length are range-filtered to `max_range` and
    resampled to `num_points` (numpy generator seeded with 0, as in the JAX
    runner); both default to the `DataConfig` the model was trained with
    (`model.data_cfg`, set when built from a checkpoint), else to
    `DataConfig`'s defaults.  `icp` in {None, 'point_to_point',
    'point_to_plane'} also refines the pose.  Returns {'transform': [4, 4],
    'rotation': [3, 3], 'translation': [3]} and, with `icp`,
    'transform_icp': [4, 4], as nested lists of floats.
    """
    data_cfg = getattr(model, 'data_cfg', DataConfig())
    max_range = data_cfg.max_range if max_range is None else max_range
    num_points = data_cfg.pcd_min_samples if num_points is None else num_points
    rng = np.random.default_rng(0)
    prep = []
    for pts in (src_points, dst_points):
        pts = np.asarray(pts, np.float32)[..., :3]
        pts, _ = range_filter(pts, max_range)
        pts, _ = resample(pts, num_points, rng)
        prep.append(pts[None])
    out = register(model, prep[0], prep[1], device=device)
    R, t = out['rotation'], out['translation']
    pose = se3.pack(R, t)
    result = {'transform': pose[0].double().cpu().tolist(),
              'rotation': R[0].double().cpu().tolist(),
              'translation': t[0].double().cpu().tolist()}
    if icp is not None:
        src, dst = (torch.from_numpy(p).to(pose.device) for p in prep)
        refined = refine(src, dst, pose, icp, icp_threshold, icp_iters)
        result['transform_icp'] = refined[0].double().cpu().tolist()
    return result
