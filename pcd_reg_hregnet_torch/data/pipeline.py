"""Host-side preprocessing: filter, resample, decalibrate, batch (port of
`pcd_reg_hregnet_tpu/data/pipeline.py`).

Everything here is numpy on the host; arrays leave with fixed shapes.
Decalibration protocol: val/test use a persisted per-index twist table
[N, 6]; ``igt`` moves the calibrated right cloud into the decalibrated
source, and ground truth is ``inverse(igt)``.  The JAX package draws its
tables from a JAX PRNG, which the port cannot regenerate: it reads the
tables that `tools/export_torch_weights.py` wrote (the JAX
`perturbation_table` CSV format) and raises where one is missing, or where
the config's perturbation fields differ from those the exported tables
were drawn with.  The
train split draws fresh twists every epoch (`PairDataset.set_epoch`) from a
numpy generator seeded by (seed, epoch): the JAX package's distribution,
not its numbers (JAX's threefry stream is not reproduced).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.config import ASSETS_DIR, DataConfig
from ..geometry import se3
from ..geometry.perturbations import sample_twist
from . import native


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


def minmax_scale(x: np.ndarray, max_value: float = 1.0) -> np.ndarray:
    """Normalise intensities to [0, 1]."""
    lo, hi = float(x.min(initial=0.0)), float(x.max(initial=max_value))
    return (x - lo) / (hi - lo + 1e-12)


def read_perturbation_table(path: str, length: int) -> np.ndarray:
    """The eval twist table [length, 6] from its CSV file (the read side of
    the JAX `perturbation_table`)."""
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f'no twist table at {path!r}: the port reads the JAX package\'s eval '
            f'tables, written by tools/export_torch_weights.py')
    table = np.loadtxt(path, dtype=np.float32, delimiter=',').reshape(-1, 6)
    if len(table) < length:
        raise ValueError(f'{path}: {len(table)} twists, the split needs {length}')
    return table[:length]


def twists_to_igts(twists: np.ndarray) -> np.ndarray:
    """[n, 6] twists -> [n, 4, 4] f32 decalibrations (se3.exp in f32)."""
    return se3.exp(torch.from_numpy(np.asarray(twists, np.float32))).numpy()


def apply_decalibration(pcd_right: np.ndarray, twist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decalibrate the (already left-frame-aligned) right cloud.

    Returns (uncalibed_pcd, igt)."""
    igt = twists_to_igts(twist)
    pts = pcd_right @ igt[:3, :3].T + igt[:3, 3]
    return pts.astype(np.float32), igt


# The fields of `DataConfig` that shape an eval twist table.  The exported
# tables in `port_assets/` were drawn with `DataConfig()`'s values of them
# (seeds 1 and 2; `tools/export_torch_weights.py`).
TABLE_FIELDS = ('max_rot_error', 'max_trans_error', 'distribution', 'mag_randomly')


def default_table_path(cfg: DataConfig, split: str) -> str:
    """Where a split's twist table lives: under `cfg.path` as in the JAX
    package, else the exported synthetic tables in `port_assets/`, which
    hold only for a config with their `TABLE_FIELDS` (else ValueError)."""
    if cfg.path:
        return os.path.join(cfg.path, f'perturbations_file_{split}.txt')
    drawn = DataConfig()
    differ = [f for f in TABLE_FIELDS if getattr(cfg, f) != getattr(drawn, f)]
    if differ:
        raise ValueError(
            f'the exported {split} twist table in port_assets/ was drawn with '
            + ', '.join(f'{f}={getattr(drawn, f)!r}' for f in differ) + '; this config has '
            + ', '.join(f'{f}={getattr(cfg, f)!r}' for f in differ)
            + f'.  The port cannot draw the JAX package\'s tables: set cfg.path to a '
            f'directory holding perturbations_file_{split}.txt')
    return str(ASSETS_DIR / f'perturbations_{cfg.dataset}_{split}.txt')


class PairDataset:
    """Fixed-shape registration-pair dataset over a raw pair source.

    A *source* provides `__len__` and `load_pair(index) -> dict` with
    `pcd_left`, `pcd_right` ([Ni, 3], already in the left frame), optional
    intensities, and `extrinsic` [4, 4].  This adds the native range
    filter + fixed-N resample and the decalibration protocol: the train
    split's twists are drawn anew each epoch (`set_epoch`), the val/test
    ones read from their table.
    """

    def __init__(self, source, cfg: DataConfig, split: str,
                 perturb_path: Optional[str] = None, seed: int = 0):
        self.source = source
        self.cfg = cfg
        self.split = split
        self.seed = seed
        self.epoch = 0
        self._igts = None
        self._table = None
        self._perturb_path = perturb_path or (None if split == 'train' else
                                              default_table_path(cfg, split))

    @property
    def table(self) -> Optional[np.ndarray]:
        """Deterministic eval twist table [len, 6] (None for the train split)."""
        if self.split == 'train':
            return None
        if self._table is None:
            self._table = read_perturbation_table(self._perturb_path, len(self.source))
        return self._table

    def set_epoch(self, epoch: int) -> None:
        """Fresh random train decalibrations each epoch (the reference draws a
        new twist per item per epoch); the resampling also follows the
        epoch."""
        if epoch != self.epoch or (self.split == 'train' and self._igts is None):
            self.epoch = epoch
            if self.split == 'train':
                self._igts = self._epoch_igts(epoch)

    def _epoch_igts(self, epoch: int) -> np.ndarray:
        """The epoch's decalibrations [len, 4, 4], drawn in one call from a
        generator seeded by (seed, epoch)."""
        twists = sample_twist(np.random.default_rng((self.seed, epoch)),
                              self.cfg.max_rot_error, self.cfg.max_trans_error,
                              self.cfg.distribution, self.cfg.mag_randomly,
                              shape=(len(self.source),))
        return se3.exp(twists).numpy()

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        raw = self.source.load_pair(index)
        rng = np.random.default_rng((self.seed, self.epoch, index))
        out = {}
        for side in ('left', 'right'):
            pts = np.asarray(raw[f'pcd_{side}'], np.float32)
            inten = raw.get(f'intensity_{side}')
            rec = pts[:, :3] if inten is None else np.column_stack(
                [pts[:, :3], np.asarray(inten, np.float32)])
            seed = int(rng.integers(0, 2 ** 62))
            pts, inten = native.filter_resample(
                np.ascontiguousarray(rec), self.cfg.max_range,
                self.cfg.pcd_min_samples, seed)
            out[f'pcd_{side}'] = pts
            out[f'intensity_{side}'] = (minmax_scale(inten, self.cfg.max_intensity)
                                        if inten is not None else
                                        np.zeros(len(pts), np.float32))
        if self._igts is None:
            self._igts = (self._epoch_igts(self.epoch) if self.split == 'train'
                          else twists_to_igts(self.table))
        igt = self._igts[index]
        pts = out['pcd_right'] @ igt[:3, :3].T + igt[:3, 3]
        out['uncalibed_pcd'] = pts.astype(np.float32)
        out['igt'] = igt
        out['extrinsic'] = np.asarray(raw.get('extrinsic', np.eye(4)), np.float32)
        return out


def batch_iterator(dataset, batch_size: int, *, shuffle: bool = False,
                   seed: int = 0, drop_last: bool = True, epoch: int = 0,
                   skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Stack fixed-shape items into [B, ...] arrays, in the JAX package's
    order; with `drop_last=False` the last batch may be shorter.  The first
    `skip` batches are passed over without loading (a resumed epoch)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(skip * batch_size, end, batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}
