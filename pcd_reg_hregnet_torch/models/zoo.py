"""Named model presets (port of `pcd_reg_hregnet_tpu/models/zoo.py`).

Only the presets the port can build are listed: `model_v6` (PTv3
descriptor backbone, SVD head) for now.
"""
from __future__ import annotations

import dataclasses
import math

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
          **overrides) -> RegistrationModel:
    """Build a preset in eval mode on `device` with seeded random weights.

    Raises without a card unless ``device='cpu'``.  Load trained weights
    with ``model.load_state_dict(utils.convert.from_flax(variables))``.
    """
    dev = resolve_device(device)
    model = RegistrationModel(model_config(name, **overrides))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()

