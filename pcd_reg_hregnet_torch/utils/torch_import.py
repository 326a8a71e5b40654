"""Import reference PyTorch checkpoints into the port (port of
`pcd_reg_hregnet_tpu/utils/torch_import.py`).

The reference warm-starts registration training from pretrained NuScenes
feature weights (`nusc_{keypoints,feats}.pth`, loaded strict=False).
`convert_backbone` maps such a `state_dict` onto the flax-layout tree of
`HierFeatureExtraction` (nested dicts of numpy arrays, the JAX package's
names), and `merge_into` puts that tree into a port model's `state_dict`
through `utils/convert.py::from_flax`: the same values, bit for bit.

Layout translation (channels-last design):
  torch Conv2d/Conv1d 1x1  [out, in, 1(,1)]  ->  Dense kernel [in, out]
  torch BatchNorm weight/bias                ->  BatchNorm scale/bias
  torch running_mean/var                     ->  batch_stats mean/var

Structural map (the reference's `models/HRegNet/layers.py`):
  detector_i.convs.{3j}   -> detector_i/ConvBNReLU_0/Dense_j
  detector_i.convs.{3j+1} -> detector_i/ConvBNReLU_0/BatchNorm_j
  detector_i.mlp1/mlp2    -> detector_i/MLPHead_0/Dense_0,1 + BatchNorm_0,1
  detector_i.mlp3         -> detector_i/MLPHead_0/Dense_2
  desc_extractor_i.convs  -> desc_extractor_i/ConvBNReLU_0/...
  desc_extractor_i.mlp1   -> desc_extractor_i/ConvBNReLU_1/...
  desc_extractor_i.mlp2   -> desc_extractor_i/ConvBNReLU_2/...
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .convert import from_flax


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint to numpy (bare and `net_state_dict`-wrapped
    dicts), reading tensors only (`weights_only=True`)."""
    raw = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(raw, dict) and 'net_state_dict' in raw:
        raw = raw['net_state_dict']
    return {k: v.detach().numpy() for k, v in raw.items()
            if hasattr(v, 'detach')}


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """[out, in, 1(, 1)] -> [in, out]."""
    return w.reshape(w.shape[0], w.shape[1]).T.copy()


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_backbone(state_dict: Dict[str, np.ndarray]):
    """Convert a HierFeatureExtraction state_dict.

    Returns (params, batch_stats) nested dicts keyed like the flax tree of
    `models/registration.HierFeatureExtraction` (conv backbone).
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def seq_module(prefix_t, prefix_f):
        """Map a torch Sequential of (Conv, BN, ReLU)* under `prefix_t`."""
        j = 0
        while f'{prefix_t}.{3 * j}.weight' in state_dict:
            conv = state_dict[f'{prefix_t}.{3 * j}.weight']
            _set(params, prefix_f + (f'Dense_{j}', 'kernel'), _conv_kernel(conv))
            bn = f'{prefix_t}.{3 * j + 1}'
            if f'{bn}.weight' in state_dict:
                _set(params, prefix_f + (f'BatchNorm_{j}', 'scale'),
                     state_dict[f'{bn}.weight'].copy())
                _set(params, prefix_f + (f'BatchNorm_{j}', 'bias'),
                     state_dict[f'{bn}.bias'].copy())
                _set(stats, prefix_f + (f'BatchNorm_{j}', 'mean'),
                     state_dict[f'{bn}.running_mean'].copy())
                _set(stats, prefix_f + (f'BatchNorm_{j}', 'var'),
                     state_dict[f'{bn}.running_var'].copy())
            j += 1
        return j

    for i in (1, 2, 3):
        det_t = f'detector_{i}'
        if f'{det_t}.convs.0.weight' not in state_dict:
            continue
        det_f = (det_t,)
        seq_module(f'{det_t}.convs', det_f + ('ConvBNReLU_0',))
        # sigma head: mlp1/mlp2 are Conv1d+BN+ReLU; mlp3 a biased Conv1d
        for m, dense_idx in (('mlp1', 0), ('mlp2', 1)):
            conv = state_dict[f'{det_t}.{m}.0.weight']
            _set(params, det_f + ('MLPHead_0', f'Dense_{dense_idx}', 'kernel'),
                 _conv_kernel(conv))
            _set(params, det_f + ('MLPHead_0', f'Dense_{dense_idx}', 'bias'),
                 state_dict[f'{det_t}.{m}.0.bias'].copy())
            bn = f'{det_t}.{m}.1'
            _set(params, det_f + ('MLPHead_0', f'BatchNorm_{dense_idx}', 'scale'),
                 state_dict[f'{bn}.weight'].copy())
            _set(params, det_f + ('MLPHead_0', f'BatchNorm_{dense_idx}', 'bias'),
                 state_dict[f'{bn}.bias'].copy())
            _set(stats, det_f + ('MLPHead_0', f'BatchNorm_{dense_idx}', 'mean'),
                 state_dict[f'{bn}.running_mean'].copy())
            _set(stats, det_f + ('MLPHead_0', f'BatchNorm_{dense_idx}', 'var'),
                 state_dict[f'{bn}.running_var'].copy())
        _set(params, det_f + ('MLPHead_0', 'Dense_2', 'kernel'),
             _conv_kernel(state_dict[f'{det_t}.mlp3.0.weight']))
        _set(params, det_f + ('MLPHead_0', 'Dense_2', 'bias'),
             state_dict[f'{det_t}.mlp3.0.bias'].copy())

    for i in (1, 2, 3):
        ext_t = f'desc_extractor_{i}'
        if f'{ext_t}.convs.0.weight' not in state_dict:
            continue
        ext_f = (ext_t,)
        seq_module(f'{ext_t}.convs', ext_f + ('ConvBNReLU_0',))
        seq_module(f'{ext_t}.mlp1', ext_f + ('ConvBNReLU_1',))
        seq_module(f'{ext_t}.mlp2', ext_f + ('ConvBNReLU_2',))

    return params, stats


def merge_into(state_dict: Dict[str, torch.Tensor], params: Dict, stats: Dict,
               prefix: Tuple[str, ...] = ('feature_extraction',)) -> Dict[str, torch.Tensor]:
    """`state_dict` (a port model's, e.g. `RegistrationModel.state_dict()`)
    with the converted subtrees put in under `prefix` (the strict=False warm
    start of the reference).  Every imported leaf must have a target of the
    same shape: KeyError where none, ValueError on a shape mismatch.  The
    values keep the target's dtype and device."""
    imported = from_flax({'params': params, 'batch_stats': stats})
    out = dict(state_dict)
    for key, value in imported.items():
        name = '.'.join(prefix + (key,))
        if name not in out:
            raise KeyError(f'no target for imported param {name}')
        if tuple(out[name].shape) != tuple(value.shape):
            raise ValueError(f'shape mismatch at {name}: {tuple(out[name].shape)} vs '
                             f'imported {tuple(value.shape)}')
        out[name] = value.to(dtype=out[name].dtype, device=out[name].device)
    return out
