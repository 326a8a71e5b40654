"""Named model presets (port of `pcd_reg_hregnet_tpu/models/zoo.py`).

* hregnet  - conv descriptors, SVD head (the reference's HRegNet)
* model_v1 - + MI outputs from CoarseReg
* model_v2 - + MI outputs from FineReg2 after the coarse pose (A1)
* model_v3 - model_v2 with the MLP regression head
* model_v4 - model_v2 + overlap-circle distances from CoarseReg
* model_v5 - self-attention detectors, cross-attention correspondences
             (`models/attention.py`)
* model_v6 - PTv3 descriptor backbone (A2, the flagship)

`build_ptv3` builds the full PointTransformerV3 encoder-decoder
(`models/ptv3.py`), which no preset uses.

Every preset builds in `compute_dtype` float32 or bfloat16 (the JAX
package's bf16 policy, `models/layers.py`); any other compute dtype is
refused with `NotImplementedError`.  `seq_axis` shards the PTv3 encoders'
serialized order at eval (`parallel/sequence.py`).  `available()` lists
the presets.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.device import resolve_device
from .attention import AttentionRegistrationModel
from .registration import RegistrationModel

_PRESETS = {
    'hregnet': ModelConfig(name='hregnet'),
    'model_v1': ModelConfig(name='model_v1', mi_from_coarse=True),
    'model_v2': ModelConfig(name='model_v2', mi_from_fine2=True),
    'model_v3': ModelConfig(name='model_v3', mi_from_fine2=True, head='regression'),
    'model_v4': ModelConfig(name='model_v4', mi_from_fine2=True, circle_dists=True),
    'model_v5': ModelConfig(name='model_v5', backbone='attention', mi_from_fine2=True),
    'model_v6': ModelConfig(name='model_v6', backbone='ptv3',
                            mi_from_fine2=True, circle_dists=True),
}


def model_config(name: str, **overrides) -> ModelConfig:
    """Get the preset ModelConfig for a model name."""
    if name not in _PRESETS:
        raise KeyError(f'unknown model {name!r}; available: {sorted(_PRESETS)}')
    cfg = _PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def available() -> list[str]:
    """The preset names, sorted."""
    return sorted(_PRESETS)


# std of a standard normal truncated to [-2, 2] (flax's variance_scaling
# divides by it, so that the truncated draw keeps the variance 1/fan_in)
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(shape: tuple, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, `lecun_normal`: a normal of std
    sqrt(1/fan_in) / TRUNCATED_STD truncated to two of its stds, drawn by
    inverse CDF (in f64) from uniforms of `generator`; f32 on the CPU."""
    lo, hi = (0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    return (z.clamp(-2.0, 2.0) * std).float()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded flax-style init: every weight of fan-in f drawn from flax's
    lecun_normal (a normal of std sqrt(1/f) / TRUNCATED_STD truncated to
    two stds, so of variance 1/f), biases 0, norm scales 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        owner = model.get_submodule(name.rsplit('.', 1)[0])
        if leaf == 'bias':
            p.zero_()
        elif isinstance(owner, (nn.Linear, nn.Conv1d)):
            p.copy_(lecun_normal_(tuple(p.shape), math.prod(p.shape[1:]), generator))
        else:
            p.fill_(1.0)


def model_for(cfg: ModelConfig) -> nn.Module:
    """The model of a configuration: model_v5's attention pipeline for
    `backbone='attention'`, `RegistrationModel` for the rest."""
    if cfg.backbone == 'attention':
        return AttentionRegistrationModel(cfg)
    return RegistrationModel(cfg)


def build(name: str, *, device: str | torch.device = 'cuda', seed: int = 0,
          weights: str | Path | None = None, **overrides) -> nn.Module:
    """Build a model in eval mode on `device`.

    Without `weights`: the preset with seeded random weights.  With
    `weights` (an exported `.npz` or a train checkpoint directory such as
    `runs/.../ckpt/best_rre`; `utils/checkpoint.py::read`): the model
    configuration recorded in the checkpoint, `overrides` on top, its
    model leaves loaded with ``strict=True`` (the objective's, such as the
    MI discriminators, are not the model's); the checkpoint's `DataConfig`
    is kept as `model.data_cfg`.  Raises without a card unless
    ``device='cpu'``.
    """
    dev = resolve_device(device)
    if weights is None:
        model = model_for(model_config(name, **overrides))
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        from ..utils import checkpoint
        cfg, state = checkpoint.load(weights)
        if cfg.model.name != name:
            raise ValueError(f'{weights} holds {cfg.model.name!r}, not {name!r}')
        model = model_for(dataclasses.replace(cfg.model, **overrides))
        model.load_state_dict(state, strict=True)
        model.data_cfg = cfg.data
    return model.to(dev).eval()



def build_ptv3(*, device: str | torch.device = 'cuda', seed: int = 0, in_channels: int = 3,
               **kwargs) -> nn.Module:
    """The full `PointTransformerV3` (the JAX module's defaults, `kwargs` on
    top) with seeded flax-style weights, in eval mode on `device`.  Raises
    without a card unless ``device='cpu'``."""
    from .ptv3 import PointTransformerV3
    dev = resolve_device(device)
    model = PointTransformerV3(in_channels, **kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
