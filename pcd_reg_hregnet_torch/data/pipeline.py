"""Host-side preprocessing for serving: numpy copies of
`pcd_reg_hregnet_tpu/data/pipeline.py` `range_filter` and `resample`."""
from __future__ import annotations

from typing import Optional

import numpy as np


def range_filter(points: np.ndarray, max_range: float,
                 intensity: Optional[np.ndarray] = None):
    """Drop points farther than `max_range` from the sensor."""
    keep = np.linalg.norm(points[:, :3], axis=1) < max_range
    if intensity is not None:
        return points[keep], intensity[keep]
    return points[keep], None


def resample(points: np.ndarray, num_points: int, rng: np.random.Generator,
             intensity: Optional[np.ndarray] = None):
    """Pad (random duplication) or random-subsample to a fixed count."""
    n = points.shape[0]
    if n == 0:
        points = np.zeros((1, points.shape[1]), points.dtype)
        intensity = np.zeros((1,), np.float32) if intensity is not None else None
        n = 1
    if n <= num_points:
        pad_idx = rng.choice(n, num_points - n, replace=True)
        idx = np.concatenate([np.arange(n), pad_idx])
    else:
        idx = rng.choice(n, num_points, replace=False)
    if intensity is not None:
        return points[idx], intensity[idx]
    return points[idx], None
