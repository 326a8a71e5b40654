"""Trained weights for the port (counterpart of
`pcd_reg_hregnet_tpu/train/loop.py::restore_params` and
`cli.py::_ckpt_config`).

The JAX package saves orbax checkpoints, which need orbax and tensorstore
to read.  `tools/export_torch_weights.py` turns one into an uncompressed
`.npz` of flax leaves (`params/...`, `batch_stats/...`, `/`-joined paths)
beside its `meta.json` (`<stem>.meta.json`); this module reads them with
numpy alone.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core.config import ASSETS_DIR, Config
from .convert import from_flax

FLAGSHIP = ASSETS_DIR / 'r5_v11_knn_best_rre.npz'   # reg_v11, model_v6


def meta_path(path: str | Path) -> Path:
    path = Path(path)
    return path.with_name(path.name.removesuffix('.npz') + '.meta.json')


def load_config(path: str | Path) -> Config:
    """The full `Config` recorded in the checkpoint's `meta.json`."""
    with open(meta_path(path)) as f:
        return Config.from_json(json.load(f)['config'])


def load_variables(path: str | Path) -> dict:
    """{'params': ..., 'batch_stats': ...} as nested dicts of numpy arrays."""
    variables: dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            *parents, leaf = key.split('/')
            node = variables
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return variables


def load(path: str | Path = FLAGSHIP) -> tuple[Config, dict[str, torch.Tensor]]:
    """(Config, state_dict) of an exported checkpoint."""
    return load_config(path), from_flax(load_variables(path))
