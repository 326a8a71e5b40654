"""The feats pretrain loop (port of `pcd_reg_hregnet_tpu/train/feats_loop.py`):
one stage, detector or descriptor, of `train/feats.py`'s objective.

Unlike the JAX loop, which counts `max_steps` over the steps of this call
only and stops at an epoch's end, `max_steps` here caps the optimizer
steps counted from a resumed step and may stop mid-epoch, as the port's
`train.loop.fit` does; the stage checkpoint is written then too, and a
resumed run continues at its step.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from ..core.config import Config
from ..data import load_dataset
from ..utils import checkpoint
from .feats import create_feats_state
from .loop import TrainState, _log, make_train_step, run_epoch


def fit_feats(cfg: Config, *, stage: str = 'detector', pretrain_detector: Optional[str] = None,
              log_dir: str = 'runs_feats', max_steps: Optional[int] = None, datasets=None,
              device: str | torch.device = 'cuda') -> tuple[TrainState, Dict[str, float]]:
    """Train one stage of the feature pyramid; returns (state, the last
    epoch's mean metrics over its pairs).

    `datasets` can inject (train,); `pretrain_detector` starts from the
    weights, parameters and BatchNorm statistics, of a feats checkpoint (the
    detector stage's directory, or an exported `.npz`) with a fresh
    optimizer, as the JAX loop's `restore_params` does; the stage checkpoint
    `<log_dir>/<ckpt_dir>/feats_<stage>` (written after every epoch and at
    the last step) is restored in full when it exists: weights, optimizer,
    step and epoch.  Writes one JSON line per step to
    `<log_dir>/metrics.jsonl`.
    """
    train_ds = datasets[0] if datasets else load_dataset(cfg.data, 'train')
    bs = cfg.data.batch_size
    steps_per_epoch = max(1, len(train_ds) // bs)
    state = create_feats_state(cfg, steps_per_epoch, stage=stage, device=device)
    if pretrain_detector:
        checkpoint.model_of(state.objective).load_state_dict(
            checkpoint.read(pretrain_detector)[1], strict=True)
    stage_ckpt = os.path.join(log_dir, cfg.train.ckpt_dir, f'feats_{stage}')
    if os.path.exists(os.path.join(stage_ckpt, checkpoint.TRAIN_STATE)):
        checkpoint.restore_train(stage_ckpt, state)
    step = make_train_step(cfg.train.watch)
    os.makedirs(log_dir, exist_ok=True)
    metrics: Dict[str, float] = {}
    start_epoch = min(state.step // steps_per_epoch, cfg.train.epochs)
    with open(os.path.join(log_dir, 'metrics.jsonl'), 'a') as log:
        for epoch in range(start_epoch, cfg.train.epochs):
            if max_steps is not None and state.step >= max_steps:
                break
            metrics = run_epoch(
                train_ds, step, state, bs, train=True, shuffle=True, seed=cfg.train.seed,
                epoch=epoch, skip=max(0, state.step - epoch * steps_per_epoch),
                max_batches=None if max_steps is None else max_steps - state.step,
                on_step=lambda m: _log(log, {'split': 'train', 'stage': stage, 'epoch': epoch,
                                             'step': state.step, **m}))
            state.epoch = epoch
            checkpoint.save_train(stage_ckpt, state, cfg)
    return state, metrics
