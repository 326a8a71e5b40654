"""Host-side preprocessing: filter, resample, decalibrate, batch (port of
`pcd_reg_hregnet_tpu/data/pipeline.py`).

Everything here is numpy on the host; arrays leave with fixed shapes.
Decalibration protocol: val/test use a persisted per-index twist table
[N, 6]; ``igt`` moves the calibrated right cloud into the decalibrated
source, and ground truth is ``inverse(igt)``.  The twist table of a split:

* where `cfg.path` is set (real data, or a synthetic run of the caller's
  own), ``<path>/perturbations_file_<split>.txt``: read if it exists,
  whoever wrote it; else drawn by the port itself (`draw_twist_table`: a
  numpy generator seeded by the split's seed, 1 for val and 2 for test as
  in the JAX package) and written in the JAX package's format, with a log
  line saying so.  The JAX package's `perturbation_table` reads an
  existing file before it draws, so from then on both read the same twists;
* without `cfg.path`, the synthetic tables that
  `tools/export_torch_weights.py` exported from the JAX package into
  `port_assets/`: the port cannot draw JAX's numbers (its threefry stream
  is not reproduced), so a missing one, or a config whose perturbation
  fields differ from those the tables were drawn with, is refused.

The train split draws fresh twists every epoch (`PairDataset.set_epoch`)
from a numpy generator seeded by (seed, epoch): the JAX package's
distribution, not its numbers.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.config import ASSETS_DIR, DataConfig
from ..geometry import se3
from ..geometry.perturbations import sample_twist
from . import native

log = logging.getLogger(__name__)


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


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     intensity: Optional[np.ndarray] = None):
    """Keep one point per occupied voxel, the mean of the points in it
    (and of their intensities), in the order of the voxels' keys."""
    if points.shape[0] == 0:
        return points, intensity
    coords = np.floor(points[:, :3] / float(voxel_size)).astype(np.int64)
    coords -= coords.min(axis=0)
    key = (coords[:, 0] * (coords[:, 1].max() + 1) + coords[:, 1]) \
        * (coords[:, 2].max() + 1) + coords[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    out = np.zeros((uniq.shape[0], points.shape[1]), np.float64)
    np.add.at(out, inv, points)
    out = (out / counts[:, None]).astype(points.dtype)
    if intensity is None:
        return out, None
    out_i = np.zeros((uniq.shape[0],), np.float64)
    np.add.at(out_i, inv, intensity)
    return out, (out_i / counts).astype(intensity.dtype)


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
    table = _load_table(path)
    if len(table) < length:
        raise ValueError(f'{path}: {len(table)} twists, the split needs {length}')
    return table[:length]


def _load_table(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32, delimiter=',').reshape(-1, 6)


SPLIT_SEEDS = {'val': 1, 'test': 2}   # the JAX package's table seeds; 3 for any other split


def draw_twist_table(cfg: DataConfig, split: str, length: int) -> np.ndarray:
    """The port's own eval twist table [length, 6] f32: `sample_twist` with
    the config's perturbation fields, from a numpy generator seeded by the
    split's seed (the JAX package's distribution, not its numbers)."""
    gen = np.random.default_rng(SPLIT_SEEDS.get(split, 3))
    return sample_twist(gen, cfg.max_rot_error, cfg.max_trans_error, cfg.distribution,
                        cfg.mag_randomly, shape=(length,)).numpy()


def twist_table(path: str, length: int, cfg: DataConfig, split: str) -> np.ndarray:
    """The twist table at `path`, read if it holds `length` twists, else
    drawn by `draw_twist_table` and written there in the JAX package's
    format (`np.savetxt(..., delimiter=',')`)."""
    if os.path.exists(path):
        table = _load_table(path)
        if len(table) >= length:
            return table[:length]
    table = draw_twist_table(cfg, split, length)
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    np.savetxt(path, table, delimiter=',')
    log.warning('%s: %d %s twists drawn by the port itself (numpy, seed %d; not the JAX '
                'package\'s numbers) and written; later runs of either package read them',
                path, length, split, SPLIT_SEEDS.get(split, 3))
    return table


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
        # a table of the caller's own (a path given, or under cfg.path) is
        # drawn where missing; the exported ones only read
        self._draw = bool(perturb_path or cfg.path)
        self._perturb_path = perturb_path or (None if split == 'train' else
                                              default_table_path(cfg, split))

    @property
    def table(self) -> Optional[np.ndarray]:
        """Deterministic eval twist table [len, 6] (None for the train split)."""
        if self.split == 'train':
            return None
        if self._table is None:
            self._table = (twist_table(self._perturb_path, len(self.source), self.cfg,
                                       self.split) if self._draw else
                           read_perturbation_table(self._perturb_path, len(self.source)))
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
                   skip: int = 0, num_workers: int = 0, prefetch: int = 2,
                   local_slice: Optional[slice] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Stack fixed-shape items into [B, ...] arrays, in the JAX package's
    order; with `drop_last=False` the last batch may be shorter.  The first
    `skip` batches are passed over without loading (a resumed epoch).

    With `num_workers > 0` a thread pool loads each batch's items in
    parallel and up to `prefetch` batches ahead of the consumer (the native
    filter/resample and numpy release the GIL); the batches are the
    synchronous path's.  `local_slice` loads only those rows of each batch
    (one process's share of a global batch); a batch whose share is empty
    (a short last batch) is passed over.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    end = n - (n % batch_size) if drop_last else n

    def indices(start):
        idxs = order[start:start + batch_size]
        return idxs if local_slice is None else idxs[local_slice]

    starts = [s for s in range(skip * batch_size, end, batch_size) if len(indices(s))]

    def stack(items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    if num_workers <= 0:
        for start in starts:
            yield stack([dataset[int(i)] for i in indices(start)])
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as items_pool, \
            ThreadPoolExecutor(max_workers=max(1, prefetch)) as batch_pool:
        def load(start):
            return stack(list(items_pool.map(lambda i: dataset[int(i)], indices(start))))

        pending = [batch_pool.submit(load, s) for s in starts[:prefetch + 1]]
        for s in starts[prefetch + 1:] + [None] * len(pending):
            batch = pending.pop(0).result()
            if s is not None:
                pending.append(batch_pool.submit(load, s))
            yield batch
