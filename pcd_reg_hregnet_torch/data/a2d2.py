"""Audi A2D2 LiDAR-to-LiDAR pair source (port of
`pcd_reg_hregnet_tpu/data/a2d2.py`): npz lidar sweeps per camera-direction
directory, sensor extrinsics from the view definitions (x / y axes and
origin) of ``cams_lidars.json``, and a ratio split over the sorted file
pairs.  numpy only.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..core.config import DataConfig

_EPS = 1.0e-10


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    if n < _EPS:
        raise ValueError('norm of view axis vector(s) too small')
    return v / n


def view_to_global(view: dict) -> np.ndarray:
    """A view (x-axis, y-axis, origin) -> its 4x4 transform to global, y
    re-orthogonalised against x and z = x cross y."""
    x_axis = _normalize(np.asarray(view['x-axis'], np.float64))
    y_axis = np.asarray(view['y-axis'], np.float64)
    y_axis = _normalize(y_axis - x_axis * np.dot(y_axis, x_axis))
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2] = x_axis, y_axis, np.cross(x_axis, y_axis)
    T[:3, 3] = np.asarray(view['origin'], np.float64)
    return T


def transform_from_to(src_view: dict, dst_view: dict) -> np.ndarray:
    """The transform from the `src_view` frame into the `dst_view` frame."""
    return np.linalg.inv(view_to_global(dst_view)) @ view_to_global(src_view)


class A2D2PairSource:
    """Pairs of npz lidar sweeps of two sensors, the right cloud moved into
    the left sensor's frame."""

    def __init__(self, cfg: DataConfig, split: str = 'train',
                 sensor_a: str = 'front_left', sensor_b: str = 'front_center',
                 cams_lidars_json: str = ''):
        self.cfg = cfg
        root = cfg.path
        with open(cams_lidars_json or os.path.join(root, 'cams_lidars.json')) as f:
            self.calib = json.load(f)
        self.sensor_a, self.sensor_b = sensor_a, sensor_b
        pairs = list(zip(self._lidar_files(root, f'cam_{sensor_a}'),
                         self._lidar_files(root, f'cam_{sensor_b}')))
        self.pairs = self._split(pairs, split)
        target = self.calib['vehicle']['view']
        ext_a, ext_b = (transform_from_to(self.calib['cameras'][s]['view'], target)
                        for s in (sensor_a, sensor_b))
        # maps sensor-B points into the sensor-A frame
        self.extrinsic = (np.linalg.inv(ext_a) @ ext_b).astype(np.float32)

    @staticmethod
    def _lidar_files(root: str, token: str) -> List[str]:
        out = []
        for dirpath, _, files in os.walk(root):
            if token in dirpath:
                out += [os.path.join(dirpath, f) for f in files if f.endswith('.npz')]
        return sorted(out)

    def _split(self, pairs, split: str):
        r = self.cfg.split_ratios
        n = len(pairs)
        tr, va = int(r[0] * n), int((r[0] + r[1]) * n)
        return {'train': pairs[:tr], 'val': pairs[tr:va], 'test': pairs[va:]}[split]

    def __len__(self) -> int:
        return len(self.pairs)

    def load_pair(self, index: int) -> Dict[str, np.ndarray]:
        data_a, data_b = (np.load(p) for p in self.pairs[index])
        left = np.asarray(data_a['pcloud_points'], np.float32)
        right = np.asarray(data_b['pcloud_points'], np.float32)
        right = right @ self.extrinsic[:3, :3].T + self.extrinsic[:3, 3]
        return dict(pcd_left=left, pcd_right=right,
                    intensity_left=np.asarray(data_a['pcloud_attr.reflectance'], np.float32),
                    intensity_right=np.asarray(data_b['pcloud_attr.reflectance'], np.float32),
                    extrinsic=self.extrinsic)
