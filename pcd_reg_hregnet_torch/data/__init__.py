"""Dataset dispatch (port of `pcd_reg_hregnet_tpu/data/__init__.py`)."""
from __future__ import annotations

from ..core.config import DataConfig
from .pipeline import PairDataset, batch_iterator
from .synthetic import SyntheticPairSource


def load_dataset(cfg: DataConfig, split: str = 'train', **kwargs) -> PairDataset:
    """A fixed-shape pair dataset of the configured source: 'synthetic' only
    (train 2048 / val 256 / test 256 pairs, seeds 0 / 101 / 202)."""
    if cfg.dataset == 'synthetic':
        source = SyntheticPairSource(
            length=kwargs.pop('length', {'train': 2048, 'val': 256, 'test': 256}[split]),
            points_per_cloud=kwargs.pop('points_per_cloud', 2 * cfg.pcd_min_samples),
            seed={'train': 0, 'val': 101, 'test': 202}[split])
    elif cfg.dataset in ('man', 'audi'):
        raise NotImplementedError(
            f'dataset {cfg.dataset!r} is not ported yet (ROADMAP queue 1 item 12, '
            f'real data sources); use synthetic')
    elif cfg.dataset in ('kitti', 'nuscenes'):
        raise NotImplementedError(
            f'{cfg.dataset!r} is a declared-but-unimplemented source in the '
            f'reference as well; use synthetic')
    else:
        raise ValueError(f'unknown dataset {cfg.dataset!r}')
    return PairDataset(source, cfg, split)


__all__ = ['load_dataset', 'PairDataset', 'batch_iterator', 'SyntheticPairSource']
