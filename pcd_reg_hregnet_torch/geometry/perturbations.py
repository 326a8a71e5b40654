"""Random SE(3) decalibrations (port of
`pcd_reg_hregnet_tpu/geometry/perturbations.py`).

Draws come from an explicit generator, a `numpy.random.Generator` or a
`torch.Generator`: the same distributions as the JAX package, not its
numbers (JAX's threefry stream is not reproduced).
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


def _sample_invgauss(gen: Generator, mu: float, scale: float, shape: tuple = ()) -> torch.Tensor:
    """Inverse-Gaussian samples, scipy's ``invgauss.rvs(mu, scale=scale)``
    (scale * Wald(mu, lambda=1)), by the Michael-Schucany-Haas transform."""
    y = _normal(gen, tuple(shape)) ** 2
    x = mu + 0.5 * mu * mu * y - 0.5 * mu * torch.sqrt(4.0 * mu * y + mu * mu * y * y)
    u = _uniform(gen, tuple(shape))
    return scale * torch.where(u <= mu / (mu + x), x, mu * mu / torch.clamp_min(x, 1e-30))


def sample_twist(gen: Generator, max_deg: float, max_tran: float,
                 distribution: str = 'uniform', mag_randomly: bool = True,
                 shape: tuple = ()) -> torch.Tensor:
    """Twists [*shape, 6] = [w, v] (f32, CPU) of random decalibrations.

    The rotation and translation magnitudes are uniform in [0, max_deg]
    degrees and [0, max_tran] m when `mag_randomly`, else the maxima.
    'uniform': each component of w and t uniform in [-amp, amp] and
    [-tran, tran]; 'gaussian': w and t along normal directions with norms
    amp and tran; 'inverse_gaussian': along inverse-Gaussian directions
    (the reference's mu 1.0 / scale 0.1 for w, 0.01 / 0.002 for t, all in
    the positive octant) with norms amp and tran.  As in the JAX package the twist is log(pack(exp(w), t)),
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
        w = _sample_invgauss(gen, 1.0, 0.1, shape + (3,))
        w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-12) * amp
        t = _sample_invgauss(gen, 0.01, 0.002, shape + (3,))
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12) * tran
    else:
        raise ValueError(f'unsupported distribution: {distribution}')
    return se3.log(se3.pack(so3.exp(w), t))


def sample_igt(gen: Generator, max_deg: float = 20.0, max_tran: float = 0.5,
               distribution: str = 'uniform', mag_randomly: bool = True,
               batch: int = 1) -> torch.Tensor:
    """A batch of decalibrations igt [batch, 4, 4] (f32, CPU): apply with
    `se3.transform(igt, points)`; the registration ground truth is
    `se3.inverse(igt)`."""
    return se3.exp(sample_twist(gen, max_deg, max_tran, distribution, mag_randomly,
                                shape=(batch,)))
