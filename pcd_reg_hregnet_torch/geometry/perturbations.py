"""Random SE(3) decalibration twists (port of
`pcd_reg_hregnet_tpu/geometry/perturbations.py::sample_twist`).

Draws come from an explicit generator, a `numpy.random.Generator` or a
`torch.Generator`: the same distributions as the JAX package, not its
numbers (JAX's threefry stream is not reproduced).  The inverse-Gaussian
direction distribution is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import se3, so3

Generator = np.random.Generator | torch.Generator


def _uniform(gen: Generator, shape: tuple) -> torch.Tensor:
    if isinstance(gen, np.random.Generator):
        return torch.from_numpy(gen.random(shape, dtype=np.float32))
    return torch.rand(shape, generator=gen)


def _normal(gen: Generator, shape: tuple) -> torch.Tensor:
    if isinstance(gen, np.random.Generator):
        return torch.from_numpy(gen.standard_normal(shape, dtype=np.float32))
    return torch.randn(shape, generator=gen)


def sample_twist(gen: Generator, max_deg: float, max_tran: float,
                 distribution: str = 'uniform', mag_randomly: bool = True,
                 shape: tuple = ()) -> torch.Tensor:
    """Twists [*shape, 6] = [w, v] (f32, CPU) of random decalibrations.

    The rotation and translation magnitudes are uniform in [0, max_deg]
    degrees and [0, max_tran] m when `mag_randomly`, else the maxima.
    'uniform': each component of w and t uniform in [-amp, amp] and
    [-tran, tran]; 'gaussian': w and t along normal directions with norms
    amp and tran.  As in the JAX package the twist is log(pack(exp(w), t)),
    so its translational part is V(w)^-1 t and the transform moves points
    by t.
    """
    shape = tuple(shape)
    if mag_randomly:
        deg = _uniform(gen, shape) * max_deg
        tran = _uniform(gen, shape) * max_tran
    else:
        deg = torch.full(shape, float(max_deg))
        tran = torch.full(shape, float(max_tran))
    amp = (deg * math.pi / 180.0)[..., None]
    tran = tran[..., None]
    if distribution == 'uniform':
        w = (2.0 * _uniform(gen, shape + (3,)) - 1.0) * amp
        t = (2.0 * _uniform(gen, shape + (3,)) - 1.0) * tran
    elif distribution == 'gaussian':
        w = _normal(gen, shape + (3,))
        w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-12) * amp
        t = _normal(gen, shape + (3,))
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12) * tran
    elif distribution == 'inverse_gaussian':
        raise NotImplementedError('the inverse-Gaussian twist distribution is not ported '
                                  'yet; use uniform or gaussian')
    else:
        raise ValueError(f'unsupported distribution: {distribution}')
    return se3.log(se3.pack(so3.exp(w), t))
