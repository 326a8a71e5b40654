"""Deep mutual-information (Jensen-Shannon) loss with learned
discriminators (port of `pcd_reg_hregnet_tpu/losses/mi.py`).

The discriminators carry the flax names (`local_d`, `global_d`, each with
`Dense_j`), so the JAX objective's `mi_loss` leaves load by
`utils.convert.from_flax`.  Local tensors are [B, N, C], global ones [B, D]
(the per-point weight vectors of length N); each discriminator sees the
concat of the context and the sample, so its first Dense takes twice the
configured width.  Their Dense layers promote, as flax's `dtype=None`:
bf16 features of a bf16 model meet the f32 parameters in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense


class GlobalInfoNet(nn.Module):
    """Vector discriminator: three (Dense, ReLU) without bias, then a biased
    Dense to one logit [B, 1]."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.Dense_0 = Dense(2 * c, c // 2, bias=False)
        self.Dense_1 = Dense(c // 2, c // 4, bias=False)
        self.Dense_2 = Dense(c // 4, c // 8, bias=False)
        self.Dense_3 = Dense(c // 8, 1)

    def forward(self, x_global, c_global):
        h = torch.cat([x_global, c_global], dim=-1)
        h = F.relu(self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(h))))))
        return self.Dense_3(h)


class LocalInfoNet(nn.Module):
    """Per-point discriminator: three (Dense, ReLU) without bias, the last to
    one channel, so the logit [B, N] is a ReLU's output, as in the JAX
    package and the reference."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.Dense_0 = Dense(2 * c, c // 2, bias=False)
        self.Dense_1 = Dense(c // 2, c // 4, bias=False)
        self.Dense_2 = Dense(c // 4, 1, bias=False)

    def forward(self, x_local, c_local):
        h = torch.cat([x_local, c_local], dim=-1)
        h = F.relu(self.Dense_2(F.relu(self.Dense_1(F.relu(self.Dense_0(h))))))
        return h[..., 0]


class DeepMILoss(nn.Module):
    """JSD MI bound 0.5 * (E softplus(T(neg)) + E softplus(-T(pos))) per
    head, summed over the heads present.  The negatives are the model's
    batch-rolled primes."""

    def __init__(self, global_in_channels: Optional[int] = None,
                 local_in_channels: Optional[int] = None):
        super().__init__()
        if global_in_channels is None and local_in_channels is None:
            raise ValueError('MI loss needs at least one of global/local heads')
        if local_in_channels is not None:
            self.local_d = LocalInfoNet(local_in_channels)
        if global_in_channels is not None:
            self.global_d = GlobalInfoNet(global_in_channels)

    def forward(self, x_global=None, x_global_prime=None, x_local=None,
                x_local_prime=None, c_local=None, c_global=None):
        total = 0.0
        if hasattr(self, 'local_d'):
            ej = -F.softplus(-self.local_d(c_local, x_local)).mean()
            em = F.softplus(self.local_d(c_local, x_local_prime)).mean()
            total = total + 0.5 * (em - ej)
        if hasattr(self, 'global_d'):
            ej = -F.softplus(-self.global_d(c_global, x_global)).mean()
            em = F.softplus(self.global_d(c_global, x_global_prime)).mean()
            total = total + 0.5 * (em - ej)
        return total
