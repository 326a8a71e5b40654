"""flax variables -> the port's `state_dict` (the reverse of
`pcd_reg_hregnet_tpu/utils/torch_import.py`).

The port's submodules carry the flax auto-names, so a flax path
``a/b/Dense_0/kernel`` becomes the key ``a.b.Dense_0.weight``:

* Dense kernel [in, out] -> Linear weight [out, in];
* Conv kernel [k, in/groups, C] -> Conv1d weight [C, in/groups, k];
* BatchNorm / LayerNorm scale -> weight, bias -> bias;
* batch_stats mean -> running_mean, var -> running_var.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Turn ``{'params': ..., 'batch_stats': ...}`` (nested dicts of numpy
    arrays) into a `state_dict` for the matching port module."""
    state = {}
    for collection, leaves in (('params', _PARAM_LEAVES),
                               ('batch_stats', _STAT_LEAVES)):
        for path, value in _flatten(variables.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(f'unexpected flax leaf {"/".join(path)}')
            a = np.asarray(value, dtype=np.float32)
            if path[-1] == 'kernel':
                a = a.T if a.ndim == 2 else np.transpose(a, (2, 1, 0))
            state['.'.join(path[:-1] + (leaves[path[-1]],))] = torch.tensor(a)
    return state
