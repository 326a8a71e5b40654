"""Named experiment presets (port of `pcd_reg_hregnet_tpu/train/experiments.py`):
the reference's train-script matrix as `Config` data, copied entry for
entry.

`experiment(name)` returns the full `Config`.  Every entry trains on the
port, in f32 or in bf16 (`--compute-dtype`): every model preset (conv,
PTv3 and attention backbones, SVD and regression heads, MI from the
coarse or the second level) and the transformation, chamfer, MI and
circle losses.  Still refused (`NotImplementedError`, where the model is
built): a compute dtype other than float32 and bfloat16.  `seq_axis`,
which no entry sets, is the eval's (`eval.runner.evaluate(seq_parallel=)`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.config import Config, DataConfig, LevelConfig, LossConfig, TrainConfig
from ..models.zoo import model_config


def _cfg(model_name: str, loss: LossConfig, train: TrainConfig = TrainConfig(),
         **model_overrides) -> Config:
    return Config(model=model_config(model_name, **model_overrides),
                  loss=loss, train=train, data=DataConfig())


_V11_TRAIN = TrainConfig(optimizer='adamw', schedule='onecycle', lr=1e-4,
                         block_lr=1e-5, weight_decay=5e-5, grad_clip=1.0)
_LEGACY_TRAIN = TrainConfig(optimizer='adam', schedule='step', lr=1e-3,
                            step_size=10, step_gamma=0.5)

_EXPERIMENTS: Dict[str, Config] = {
    'reg_v0': _cfg('hregnet', LossConfig()),
    'reg_v1': _cfg('hregnet', LossConfig(), head='regression'),
    'reg_v2': _cfg('model_v1', LossConfig(transformation=False, chamfer=True,
                                          mi=True, detach_transformation=True)),
    'reg_v3': _cfg('hregnet', LossConfig(chamfer=True)),
    'reg_v4': _cfg('model_v1', LossConfig(mi=True)),
    'reg_v5': _cfg('model_v1', LossConfig(chamfer=True, mi=True)),
    'reg_v6': _cfg('model_v2', LossConfig(chamfer=True, mi=True)),
    'reg_v7': _cfg('model_v3', LossConfig(chamfer=True, mi=True)),
    'reg_v8': _cfg('model_v2', LossConfig(transformation=False, chamfer=True,
                                          mi=True, detach_transformation=True)),
    'reg_v9': _cfg('model_v4', LossConfig(transformation=False, circle=True,
                                          mi=True, detach_transformation=True)),
    'reg_v10': _cfg('model_v5', LossConfig(chamfer=True, mi=True)),
    # the flagship: model_v6, SVD head, transformation loss only, AdamW with
    # a per-group LR, OneCycle and grad clip
    'reg_v11': _cfg('model_v6', LossConfig(), _V11_TRAIN),
    'reg_v12': _cfg('model_v6', LossConfig(chamfer=True, mi=True), _V11_TRAIN),
    'reg_v13': _cfg('model_v6', LossConfig(transformation=False, chamfer=True,
                                           mi=True, detach_transformation=True),
                    _V11_TRAIN),
    'man_registration': _cfg('model_v6', LossConfig(), _V11_TRAIN),
    'baseline': _cfg('hregnet', LossConfig(), _V11_TRAIN),
    'feats': dataclasses.replace(
        _cfg('hregnet', LossConfig(), _LEGACY_TRAIN),
        data=DataConfig(batch_size=16)),
    'feats_desc': dataclasses.replace(
        _cfg('hregnet', LossConfig(), dataclasses.replace(
            _LEGACY_TRAIN, freeze_detector=True)),
        data=DataConfig(batch_size=8)),
}


def experiment(name: str, **overrides) -> Config:
    """Get a named experiment Config; overrides replace top-level fields."""
    if name not in _EXPERIMENTS:
        raise KeyError(f'unknown experiment {name!r}; available: {sorted(_EXPERIMENTS)}')
    cfg = _EXPERIMENTS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def available() -> list[str]:
    return sorted(_EXPERIMENTS)


def add_config_args(ap) -> None:
    """The command-line options that pick and adjust an experiment
    (`config_from_args`; every option of the JAX package's CLI `_common`
    but `--log-dir`), and `--max-steps` and `--device`.  One parser for
    `python -m pcd_reg_hregnet_torch` (`cli.py`), `.train` and
    `.train.feats`."""
    ap.add_argument('--experiment', default='reg_v11', choices=available())
    ap.add_argument('--dataset', default=None, choices=('man', 'audi', 'synthetic'))
    ap.add_argument('--data-path', default=None,
                    help='root of the dataset\'s files (TruckScenes, A2D2) and of its twist '
                         'tables')
    ap.add_argument('--batch-size', type=int, default=None)
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--lr', type=float, default=None)
    ap.add_argument('--max-steps', type=int, default=None)
    ap.add_argument('--seed', type=int, default=None)
    ap.add_argument('--npoints', type=int, default=None, help='points per cloud')
    ap.add_argument('--compute-dtype', default=None, choices=('float32', 'bfloat16'),
                    help='activation dtype of the compute path (for this model bfloat16 '
                         'is mainly an activation-memory knob: the hot spots are gathers '
                         'and sampling, not matmul throughput)')
    ap.add_argument('--debug-scale', action='store_true',
                    help='a small keypoint pyramid and PTv3 stack, for CPU runs')
    ap.add_argument('--ptv3-cpe', default=None, choices=('knn', 'curve', 'none'),
                    help='PTv3 positional-encoding operator (ablations)')
    ap.add_argument('--ptv3-grid-size', type=float, default=None,
                    help='PTv3 serialization voxel size (ablations)')
    ap.add_argument('--watch', action='store_true', help='log per-module norms')
    ap.add_argument('--use-wandb', action='store_true',
                    help='also log to wandb where it is installed and reachable')
    ap.add_argument('--device', default='cuda')


def config_from_args(args, model_base=None) -> Config:
    """The experiment's config with the options of `add_config_args`.
    `model_base`, a `ModelConfig` (a resumed checkpoint's), replaces the
    experiment's model config before the options apply, as the JAX CLI's
    `_build_config(model_base=)` does."""
    cfg = experiment(args.experiment)
    if model_base is not None:
        cfg = dataclasses.replace(cfg, model=model_base)
    data = {k: v for k, v in (('dataset', args.dataset), ('path', args.data_path),
                              ('batch_size', args.batch_size),
                              ('pcd_min_samples', args.npoints)) if v is not None}
    train = {k: v for k, v in (('epochs', args.epochs), ('lr', args.lr), ('seed', args.seed))
             if v is not None}
    if args.watch:
        train['watch'] = True
    if args.use_wandb:
        train['use_wandb'] = True
    model = {k: v for k, v in (('compute_dtype', args.compute_dtype),
                               ('ptv3_cpe', args.ptv3_cpe),
                               ('ptv3_grid_size', args.ptv3_grid_size)) if v is not None}
    if args.debug_scale:
        model.update(levels=(LevelConfig(64, 16, (16, 16, 32), 32),
                             LevelConfig(32, 8, (32, 32, 64), 64),
                             LevelConfig(16, 8, (64, 64, 128), 128)))
        if cfg.model.backbone == 'ptv3':
            model.update(ptv3_patch_sizes=(16, 16, 16), ptv3_depths=(1,),
                         ptv3_num_heads=(2,))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               train=dataclasses.replace(cfg.train, **train),
                               model=dataclasses.replace(cfg.model, **model))
