"""MAN TruckScenes LiDAR-to-LiDAR pair source (port of
`pcd_reg_hregnet_tpu/data/truckscenes.py`).

Reads the devkit's nuScenes-style relational JSON tables (scene / sample /
sample_data / calibrated_sensor / ego_pose under ``<path>/<version>/``)
and its ``.pcd.bin`` sweeps directly, with numpy and json.  The extrinsic
maps sensor-B points into the sensor-A frame:

    T = inv(T_csA) @ inv(T_poseA) @ T_poseB @ T_csB

with T_cs* the calibrated_sensor (sensor -> ego) and T_pose* the ego_pose
(ego -> global) transforms at each sensor's sweep.  Rotations come from
`geometry.rotations.quaternion_to_matrix` in f32, as the JAX package forms
them.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.config import DataConfig
from ..geometry.rotations import quaternion_to_matrix


def _pose_matrix(record: dict) -> np.ndarray:
    """4x4 f64 transform of a (w, x, y, z) rotation and a translation."""
    T = np.eye(4)
    T[:3, :3] = quaternion_to_matrix(torch.tensor(record['rotation'], dtype=torch.float32)).numpy()
    T[:3, 3] = np.asarray(record['translation'])
    return T


def load_lidar_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a nuScenes/TruckScenes ``.pcd.bin``: float32 rows of
    (x, y, z, intensity, ...).  Returns (points [N, 3], intensity [N])."""
    raw = np.fromfile(path, dtype=np.float32)
    for width in (5, 4, 6):
        if raw.size % width == 0:
            pts = raw.reshape(-1, width)
            return pts[:, :3].copy(), pts[:, 3].copy()
    raise ValueError(f'unrecognised point record width in {path}')


class TruckScenesTables:
    """The devkit's relational JSON tables, by token."""

    TABLES = ('scene', 'sample', 'sample_data', 'calibrated_sensor', 'ego_pose', 'sensor')

    def __init__(self, dataroot: str, version: str):
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        self._rows: Dict[str, List[dict]] = {}
        self._by_token: Dict[str, Dict[str, dict]] = {}
        for name in self.TABLES:
            path = os.path.join(table_dir, f'{name}.json')
            rows = []
            if os.path.exists(path):
                with open(path) as f:
                    rows = json.load(f)
            self._rows[name] = rows
            self._by_token[name] = {r['token']: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self._by_token[table][token]

    def rows(self, table: str) -> List[dict]:
        return self._rows[table]


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _load_splits_file(cfg: DataConfig) -> Optional[Dict[str, List[str]]]:
    """The official scene-split lists ``{split: [scene names]}``:
    `cfg.splits_file` if set (FileNotFoundError if missing), else
    ``<path>/<version>/splits.json`` or ``<path>/splits.json``; None when
    no file exists."""
    if cfg.splits_file:
        if not os.path.exists(cfg.splits_file):
            raise FileNotFoundError(f'splits_file {cfg.splits_file!r} not found')
        return {k: list(v) for k, v in _read_json(cfg.splits_file).items()}
    if cfg.path:
        for path in (os.path.join(cfg.path, cfg.version, 'splits.json'),
                     os.path.join(cfg.path, 'splits.json')):
            if os.path.exists(path):
                return {k: list(v) for k, v in _read_json(path).items()}
    return None


def _hash_split(name: str, ratios) -> str:
    """Deterministic disjoint split by scene name (md5 -> [0, 1) bucket)."""
    frac = int(hashlib.md5(name.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
    if frac < ratios[0]:
        return 'train'
    if frac < ratios[0] + ratios[1]:
        return 'val'
    return 'test'


def select_scenes(scenes: List[dict], split: str, cfg: DataConfig) -> List[dict]:
    """The split's scenes: with a splits file, those whose name its split
    list holds (``mini_<split>`` for a mini version without ``<split>``);
    without one, an md5-of-name split with `cfg.split_ratios`, disjoint
    across train / val / test."""
    lists = _load_splits_file(cfg)
    if lists is not None:
        names = lists.get(split)
        if names is None and 'mini' in cfg.version:
            names = lists.get(f'mini_{split}')
        wanted = set(names or [])
        return [s for s in scenes if s['name'] in wanted]
    return [s for s in scenes if _hash_split(s['name'], cfg.split_ratios) == split]


class TruckScenesPairSource:
    """L2L pairs over the split's TruckScenes samples: each scene's sample
    chain, one pair per keyframe sample of the two `cfg.lidar_tokens`
    channels, the right cloud moved into the left sensor's frame."""

    def __init__(self, cfg: DataConfig, split: str = 'train'):
        self.cfg = cfg
        self.split = split
        self.tables = TruckScenesTables(cfg.path, cfg.version)
        self.samples = self._collect_samples(split)

    def _collect_samples(self, split: str) -> List[dict]:
        scenes = sorted(self.tables.rows('scene'), key=lambda s: s['name'])
        scenes = select_scenes(scenes, split, self.cfg)
        if self.cfg.limscenes:
            scenes = scenes[: self.cfg.limscenes]
        samples = []
        for scene in scenes:
            token = scene['first_sample_token']
            while token:
                sample = self.tables.get('sample', token)
                samples.append(sample)
                token = sample['next']
        return samples

    @property
    def scene_names(self) -> List[str]:
        """Names of the scenes this split selected."""
        seen = {self.tables.get('sample', s['token'])['scene_token'] for s in self.samples}
        return sorted(self.tables.get('scene', t)['name'] for t in seen)

    def __len__(self) -> int:
        return len(self.samples)

    def _sample_data_token(self, sample: dict, channel: str) -> str:
        if 'data' in sample:
            return sample['data'][channel]
        for row in self.tables.rows('sample_data'):   # denormalised tables
            if row['sample_token'] == sample['token'] and row.get('channel') == channel:
                return row['token']
        raise KeyError(f'no sample_data for channel {channel}')

    def extrinsic(self, token_a: str, token_b: str) -> np.ndarray:
        """The f64 transform from sweep B's sensor frame into sweep A's."""
        sd_a = self.tables.get('sample_data', token_a)
        sd_b = self.tables.get('sample_data', token_b)
        cs_a, cs_b = (_pose_matrix(self.tables.get('calibrated_sensor',
                                                   sd['calibrated_sensor_token']))
                      for sd in (sd_a, sd_b))
        pose_a, pose_b = (_pose_matrix(self.tables.get('ego_pose', sd['ego_pose_token']))
                          for sd in (sd_a, sd_b))
        return np.linalg.inv(cs_a) @ np.linalg.inv(pose_a) @ pose_b @ cs_b

    def _sweep(self, token: str) -> tuple[np.ndarray, np.ndarray]:
        sd = self.tables.get('sample_data', token)
        return load_lidar_bin(os.path.join(self.cfg.path, sd['filename']))

    def load_pair(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.samples[index]
        tok_a, tok_b = (self._sample_data_token(sample, ch) for ch in self.cfg.lidar_tokens)
        extrinsic = self.extrinsic(tok_a, tok_b).astype(np.float32)
        left, int_l = self._sweep(tok_a)
        right, int_r = self._sweep(tok_b)
        right = (right @ extrinsic[:3, :3].T + extrinsic[:3, 3]).astype(np.float32)
        return dict(pcd_left=left.astype(np.float32), pcd_right=right,
                    intensity_left=int_l, intensity_right=int_r, extrinsic=extrinsic)

    def load_camera_lidar(self, index: int) -> Dict[str, np.ndarray]:
        """C2L mode: `cfg.lidar_tokens` read as (camera channel, lidar
        channel); the lidar sweep moved into the camera frame, with the
        camera's intrinsic, image shape and image path (decoding the image
        is the caller's)."""
        sample = self.samples[index]
        cam_ch, lidar_ch = self.cfg.lidar_tokens
        tok_cam = self._sample_data_token(sample, cam_ch)
        tok_lid = self._sample_data_token(sample, lidar_ch)
        extrinsic = self.extrinsic(tok_cam, tok_lid).astype(np.float32)
        pts, inten = self._sweep(tok_lid)
        pts = (pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]).astype(np.float32)
        sd_cam = self.tables.get('sample_data', tok_cam)
        cs_cam = self.tables.get('calibrated_sensor', sd_cam['calibrated_sensor_token'])
        return dict(pcd=pts, intensity=inten, extrinsic=extrinsic,
                    intrinsic=np.asarray(cs_cam.get('camera_intrinsic', np.eye(3)), np.float32),
                    img_shape=np.asarray([sd_cam.get('height', 0), sd_cam.get('width', 0)],
                                         np.int32),
                    image_path=os.path.join(self.cfg.path, sd_cam.get('filename', '')))
