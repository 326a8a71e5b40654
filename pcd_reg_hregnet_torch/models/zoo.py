"""Named model presets (port of `pcd_reg_hregnet_tpu/models/zoo.py`).

Only the presets the port can build are listed: `model_v6` (PTv3
descriptor backbone, SVD head) for now.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.device import resolve_device
from .registration import RegistrationModel

_PRESETS = {
    'model_v6': ModelConfig(name='model_v6', backbone='ptv3',
                            mi_from_fine2=True, circle_dists=True),
}


def model_config(name: str, **overrides) -> ModelConfig:
    """Get the preset ModelConfig for a model name."""
    if name not in _PRESETS:
        raise KeyError(f'unknown model {name!r}; available: {sorted(_PRESETS)}')
    cfg = _PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded flax-style init: every weight of fan-in f drawn from
    N(0, 1/f) (flax's lecun_normal, untruncated), biases 0, norm scales 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        owner = model.get_submodule(name.rsplit('.', 1)[0])
        if leaf == 'bias':
            p.zero_()
        elif isinstance(owner, (nn.Linear, nn.Conv1d)):
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
        else:
            p.fill_(1.0)


def build(name: str, *, device: str | torch.device = 'cuda', seed: int = 0,
          weights: str | Path | None = None, **overrides) -> RegistrationModel:
    """Build a model in eval mode on `device`.

    Without `weights`: the preset with seeded random weights.  With
    `weights` (an exported checkpoint, `utils/checkpoint.py`): the model
    configuration recorded in the checkpoint, `overrides` on top, loaded
    with ``strict=True``; the checkpoint's `DataConfig` is kept as
    `model.data_cfg`.  Raises without a card unless ``device='cpu'``.
    """
    dev = resolve_device(device)
    if weights is None:
        model = RegistrationModel(model_config(name, **overrides))
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        from ..utils import checkpoint
        cfg, state = checkpoint.load(weights)
        if cfg.model.name != name:
            raise ValueError(f'{weights} holds {cfg.model.name!r}, not {name!r}')
        model = RegistrationModel(dataclasses.replace(cfg.model, **overrides))
        model.load_state_dict(state, strict=True)
        model.data_cfg = cfg.data
    return model.to(dev).eval()

