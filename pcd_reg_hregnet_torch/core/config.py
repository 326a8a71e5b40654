"""Configuration tree, copied field for field from
`pcd_reg_hregnet_tpu/core/config.py` (`LevelConfig`, `ModelConfig`,
`DataConfig`, `LossConfig`, `TrainConfig`, `MeshConfig`, `Config`), defaults
identical.  `Config.from_json` reads the `config` string of a checkpoint's
`meta.json`.

The port keeps its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence, Tuple

# What the port carries over from the JAX package's checkpoint and data
# path (`tools/export_torch_weights.py` writes it): the flagship weights as
# `.npz`, its `meta.json`, and the synthetic eval twist tables.
ASSETS_DIR = Path(__file__).resolve().parents[2] / 'port_assets'


@dataclass(frozen=True)
class LevelConfig:
    """One pyramid level of the hierarchical detector."""
    nsample: int
    k: int
    conv_channels: Tuple[int, ...]
    desc_dim: int


@dataclass(frozen=True)
class ModelConfig:
    """Registration network configuration (see the JAX package for the
    meaning of every field; the defaults are identical)."""
    name: str = 'hregnet'
    backbone: str = 'conv'            # 'conv' (DescExtractor) | 'ptv3' | 'attention' (V5)
    head: str = 'svd'                 # 'svd' | 'regression' | 'regression6d'
    use_fps: bool = True
    use_weights: bool = True
    mi_from_coarse: bool = False
    mi_from_fine2: bool = False
    circle_dists: bool = False
    coarse_k: int = 8
    fine_k: int = 8
    use_sim: bool = True
    use_neighbor: bool = True
    levels: Tuple[LevelConfig, ...] = (
        LevelConfig(1024, 64, (32, 32, 64), 64),
        LevelConfig(512, 32, (64, 64, 128), 128),
        LevelConfig(256, 16, (128, 128, 256), 256),
    )
    ptv3_depths: Tuple[int, ...] = (2, 2, 2)
    ptv3_num_heads: Tuple[int, ...] = (2, 4, 8)
    ptv3_patch_sizes: Tuple[int, ...] = (256, 128, 64)
    ptv3_grid_size: float = 0.01
    ptv3_mlp_ratio: float = 4.0
    ptv3_cpe: str = 'knn'
    compute_dtype: str = 'float32'
    seq_axis: Optional[str] = None
    fuse_towers_train: bool = False
    fuse_towers_eval: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset / decalibration protocol."""
    dataset: str = 'synthetic'        # 'man' | 'audi' | 'synthetic'
    path: str = ''
    version: str = 'v1.0-mini'
    mode: str = 'L2L'
    lidar_tokens: Tuple[str, str] = ('LIDAR_LEFT', 'LIDAR_RIGHT')
    pcd_min_samples: int = 8096
    max_range: float = 80.0
    max_rot_error: float = 20.0       # degrees
    max_trans_error: float = 0.5      # metres
    distribution: str = 'uniform'
    mag_randomly: bool = True
    max_intensity: float = 1.0
    batch_size: int = 1
    num_workers: int = 6
    limscenes: Optional[int] = None
    splits_file: str = ''
    split_ratios: Tuple[float, float, float] = (0.6, 0.3, 0.1)


@dataclass(frozen=True)
class LossConfig:
    """Loss combination."""
    transformation: bool = True
    alpha: float = 1.0
    chamfer: bool = False
    chamfer_scale: float = 50.0
    mi: bool = False
    mi_local_channels: Optional[int] = None
    mi_global_channels: Optional[int] = None
    circle: bool = False
    detach_transformation: bool = False
    layer_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 100
    lr: float = 1e-4
    block_lr: float = 1e-5
    weight_decay: float = 5e-5
    optimizer: str = 'adamw'
    schedule: str = 'onecycle'        # 'onecycle' | 'step' | 'cosine' | 'constant'
    warmup_pct: float = 0.08
    step_size: int = 10
    step_gamma: float = 0.5
    grad_clip: float = 1.0
    seed: int = 1
    freeze_detector: bool = False
    freeze_feats: bool = False
    val_every: int = 1
    watch: bool = False
    ckpt_dir: str = 'ckpt'
    use_wandb: bool = False
    runname: str = ''


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / parallelism axes."""
    data_axis: str = 'data'
    data_parallel: int = -1           # -1: all devices
    donate_state: bool = True


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> 'Config':
        raw = json.loads(s)
        return Config(
            model=_build_model(raw.get('model', {})),
            data=DataConfig(**_tupled(raw.get('data', {}), ('lidar_tokens', 'split_ratios'))),
            loss=LossConfig(**_tupled(raw.get('loss', {}), ('layer_weights',))),
            train=TrainConfig(**raw.get('train', {})),
            mesh=MeshConfig(**raw.get('mesh', {})),
        )


def _tupled(d: dict, keys: Sequence[str]) -> dict:
    d = dict(d)
    for k in keys:
        if k in d and isinstance(d[k], list):
            d[k] = tuple(d[k])
    return d


def _build_model(d: dict) -> ModelConfig:
    d = _tupled(d, ('ptv3_depths', 'ptv3_num_heads', 'ptv3_patch_sizes'))
    if 'levels' in d:
        d['levels'] = tuple(
            LevelConfig(nsample=l['nsample'], k=l['k'],
                        conv_channels=tuple(l['conv_channels']), desc_dim=l['desc_dim'])
            for l in d['levels'])
    return ModelConfig(**d)
