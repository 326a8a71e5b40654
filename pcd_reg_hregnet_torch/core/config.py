"""Model configuration, copied field for field from
`pcd_reg_hregnet_tpu/core/config.py` (`LevelConfig`, `ModelConfig`).

The port keeps its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
