"""Optimizer and learning-rate schedules with parameter groups and freezing
(port of `pcd_reg_hregnet_tpu/train/optimizer.py`, which builds an optax
chain).

The port copies optax's arithmetic rather than using `torch.optim`:
  * `make_schedule` is `optax.cosine_onecycle_schedule` (initial lr peak/25,
    final initial/1e4, phase ends at int(pct_start * total) and total),
    `cosine_decay_schedule`, staircase `exponential_decay` and
    `constant_schedule`, each a plain `step -> lr` evaluated at the 0-based
    count of updates before this one.  `torch.optim.lr_scheduler.OneCycleLR`
    ends its phases a step off against optax and cycles momentum by default;
  * the gradient is clipped to a global norm with optax's rule (g below the
    limit, else g * max / norm), not `clip_grad_norm_`'s max / (norm + 1e-6);
  * then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay
    u = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)), Adam, or SGD with
    momentum 0.9, per group with its own schedule.
Groups, from the parameter names as JAX's `group_label` reads its paths:
`frozen` (no update, no decay) for `feature_extraction` under
`freeze_feats` and `detector` under `freeze_detector`; `block` (at
`block_lr`) for any name part containing `ptv3` or `PTv3Block`; `base` (at
`lr`) for the rest.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
SGD_MOMENTUM = 0.9


def _cos32(x: float) -> np.float32:
    """cos of x rounded to f32, in f32: what XLA's f32 cos gives optax."""
    return np.float32(math.cos(float(np.float32(x))))


def make_schedule(cfg: TrainConfig, base_lr: float, steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate at update `count` (0-based), as optax computes it
    (its arithmetic in f32, so the values agree to f32 round-off even where
    a cosine is near -1)."""
    total = max(1, cfg.epochs * steps_per_epoch)
    f32 = np.float32
    if cfg.schedule == 'onecycle':
        init, div, final_div = base_lr / 25.0, 25.0, 1e4
        bounds = (0, int(cfg.warmup_pct * total), int(total))
        values = (init, init * div, init * div / (div * final_div))

        def onecycle(count: int) -> float:
            lr = values[-1] if count >= bounds[-1] else 0.0
            for j in range(2):
                if bounds[j] <= count < bounds[j + 1]:
                    pct = (count - bounds[j]) / (bounds[j + 1] - bounds[j])
                    start, end = values[j], values[j + 1]
                    lr += float(f32(end) + f32((start - end) / 2.0)
                                * (_cos32(math.pi * pct) + f32(1.0)))
            return lr
        return onecycle
    if cfg.schedule == 'cosine':
        def cosine(count: int) -> float:
            x = f32(math.pi) * f32(min(count, total)) / f32(total)
            return float(f32(base_lr) * (f32(0.5) * (f32(1.0) + _cos32(x))))
        return cosine
    if cfg.schedule == 'step':
        steps = cfg.step_size * steps_per_epoch
        if steps <= 0 or cfg.step_gamma == 0:
            return lambda count: base_lr
        return lambda count: float(f32(base_lr) * f32(cfg.step_gamma) ** f32(count // steps))
    if cfg.schedule == 'constant':
        return lambda count: base_lr
    raise ValueError(f'unknown schedule {cfg.schedule!r}')


def group_label(name: str, cfg: TrainConfig) -> str:
    """'frozen', 'block' or 'base' for a parameter name."""
    parts = name.split('.')
    if cfg.freeze_feats and any('feature_extraction' in p for p in parts):
        return 'frozen'
    if cfg.freeze_detector and any('detector' in p for p in parts):
        return 'frozen'
    if any('ptv3' in p or 'PTv3Block' in p for p in parts):
        return 'block'
    return 'base'


class Optimizer:
    """Global-norm clip, then the configured update per group, as the JAX
    package's optax chain; `state_dict` / `load_state_dict` carry the update
    count and the moments by parameter name."""

    def __init__(self, cfg: TrainConfig, named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
                 steps_per_epoch: int):
        if cfg.optimizer not in ('adamw', 'adam', 'sgd'):
            raise ValueError(f'unknown optimizer {cfg.optimizer!r}')
        self.cfg = cfg
        self.params: Dict[str, torch.nn.Parameter] = dict(named_parameters)
        self.labels = {n: group_label(n, cfg) for n in self.params}
        self.schedules = {'base': make_schedule(cfg, cfg.lr, steps_per_epoch),
                          'block': make_schedule(cfg, cfg.block_lr, steps_per_epoch)}
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for n, p in self.params.items():
            if self.labels[n] == 'frozen':
                continue
            self.state[n] = ({'trace': torch.zeros_like(p)} if cfg.optimizer == 'sgd' else
                             {'mu': torch.zeros_like(p), 'nu': torch.zeros_like(p)})

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad` (None counts as zero);
        returns the global gradient norm before clipping (a 0-d tensor)."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in self.params.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        limit = self.cfg.grad_clip
        clip = norm >= limit
        count = self.count + 1
        bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
        for n, p in self.params.items():
            label = self.labels[n]
            if label == 'frozen':
                continue
            g = grads[n]
            g = torch.where(clip, g / norm * limit, g)
            st = self.state[n]
            lr = self.schedules[label](self.count)
            if self.cfg.optimizer == 'sgd':
                st['trace'] = g + SGD_MOMENTUM * st['trace']
                u = st['trace']
            else:
                st['mu'] = (1 - B1) * g + B1 * st['mu']
                st['nu'] = (1 - B2) * (g * g) + B2 * st['nu']
                u = (st['mu'] / bc1.to(g.device)) / (torch.sqrt(st['nu'] / bc2.to(g.device)) + EPS)
                if self.cfg.optimizer == 'adamw':
                    u = u + self.cfg.weight_decay * p
            p.add_(u * -lr)
        self.count = count
        return norm

    def state_dict(self) -> dict:
        return {'count': self.count, 'state': self.state}

    def load_state_dict(self, sd: dict) -> None:
        if set(sd['state']) != set(self.state):
            raise ValueError('optimizer state names differ from the parameter groups: '
                             f'{sorted(set(sd["state"]) ^ set(self.state))[:5]}')
        self.count = int(sd['count'])
        for n, st in sd['state'].items():
            for k, v in st.items():
                self.state[n][k] = v.to(self.state[n][k].device)
