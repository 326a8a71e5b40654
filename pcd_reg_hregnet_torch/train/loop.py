"""The train loop (port of `pcd_reg_hregnet_tpu/train/loop.py`): state,
train and eval steps, epochs, per-metric best checkpoints and resume.

One device: batches go to the card (or to the CPU when the caller passes
``device='cpu'``) as they come, the ragged val tail as its own smaller
batch.  The port never pads a batch, so an epoch's mean weights each
batch's means by its count of real pairs and is exactly the mean over the
pairs.  Every step runs under `core.device.fp32_numerics`: forward,
backward and optimizer step without TF32.
"""
from __future__ import annotations

import dataclasses

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from ..core.config import Config
from ..core.device import fp32_numerics, resolve_device
from ..data import batch_iterator, load_dataset
from ..models import zoo
from ..utils import checkpoint
from .objective import RegistrationObjective
from .optimizer import Optimizer

BEST_METRICS = ('train_loss', 'val_loss', 'rre', 'rte', 'rot_err', 'trans_err')
USED = ('uncalibed_pcd', 'pcd_left', 'igt')   # what the objective reads of a batch


@dataclass
class TrainState:
    """What a run carries from step to step: the objective (model and loss),
    the optimizer, the count of optimizer steps taken, the epoch of the last
    one, and the best value of each of `BEST_METRICS` so far."""
    objective: RegistrationObjective
    optimizer: Optimizer
    step: int = 0
    epoch: int = 0
    best: Dict[str, float] = field(default_factory=lambda: {m: math.inf for m in BEST_METRICS})


def create_state(cfg: Config, steps_per_epoch: int, *, device: str | torch.device = 'cuda',
                 init: Optional[str] = None, seed: Optional[int] = None) -> TrainState:
    """A fresh state on `device`: the objective's weights (the model's,
    then the MI discriminators') seeded from `cfg.train.seed` (or `seed`;
    `models.zoo.init_weights`), or read from the checkpoint `init`
    (`utils/checkpoint.py::read`, exported or a train checkpoint directory;
    it must record `cfg.model` but for the compute dtype, which leaves the
    parameters as they are: an f32 checkpoint starts a bf16 run), the model
    and the objective's other leaves each strictly.  Raises
    `NotImplementedError` for what is not ported."""
    dev = resolve_device(device)
    objective = RegistrationObjective(cfg)
    if init is None:
        zoo.init_weights(objective, torch.Generator().manual_seed(
            cfg.train.seed if seed is None else seed))
    else:
        saved, state_dict, extra = checkpoint.read(init)
        if dataclasses.replace(saved.model, compute_dtype=cfg.model.compute_dtype) != cfg.model:
            raise ValueError(f'{init} records another model configuration than '
                             f'cfg.model:\n{saved.model}\n{cfg.model}')
        objective.model.load_state_dict(state_dict, strict=True)
        checkpoint.load_objective_state(objective, extra, init)
    objective.to(dev)
    return TrainState(objective, Optimizer(cfg.train, objective.named_parameters(),
                                           steps_per_epoch))


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The arrays the objective reads, as tensors on `device`."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in USED}


def _module_norms(named, tag: str) -> Dict[str, torch.Tensor]:
    """Global norm per second-level module (`model.feature_extraction`, ...),
    the JAX `watch` names."""
    groups: Dict[str, list] = {}
    for name, t in named:
        if t is not None:
            groups.setdefault('.'.join(name.split('.')[:2]), []).append(t)
    return {f'{tag}/{k}': torch.sqrt(sum(torch.sum(t * t) for t in ts))
            for k, ts in groups.items()}


def make_train_step(watch: bool = False) -> Callable[[TrainState, Dict], Dict]:
    """`step(state, batch) -> metrics`: forward in train mode (BatchNorm on
    batch statistics, running statistics updated), loss, backward, global-
    norm clip and the optimizer update, all under `fp32_numerics`.  Returns
    the objective's metrics and `grad_norm` (before clipping) as detached
    0-d tensors on the device; `watch=True` adds the per-module gradient
    and parameter norms (`watch_grad_norm/...`, `watch_param_norm/...`)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        objective, opt = state.objective, state.optimizer
        objective.train()
        with fp32_numerics():
            opt.zero_grad()
            loss, metrics, _ = objective(batch)
            if loss.requires_grad:   # not so with the pose loss detached
                loss.backward()
            if watch:
                metrics.update(_module_norms(
                    ((n, p.grad) for n, p in objective.named_parameters()), 'watch_grad_norm'))
                metrics.update(_module_norms(objective.named_parameters(), 'watch_param_norm'))
            metrics['grad_norm'] = opt.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step() -> Callable[[TrainState, Dict], tuple]:
    """`step(state, batch) -> (metrics, (R, t))` in eval mode, no gradient."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.objective.eval()
        _, metrics, ret = state.objective(batch)
        return metrics, (ret['rotation'][-1], ret['translation'][-1])

    return step


def run_epoch(dataset, step: Callable, state: TrainState, batch_size: int, *, train: bool,
              shuffle: bool, seed: int, epoch: int, max_batches: Optional[int] = None,
              skip: int = 0, on_step: Optional[Callable[[Dict], None]] = None) -> Dict[str, float]:
    """One pass over the dataset (or `max_batches`, after `skip` batches);
    returns each metric's mean over the pairs.  Training drops the ragged
    last batch (the reference's DataLoader); validation keeps it, weighted
    by its size."""
    if hasattr(dataset, 'set_epoch'):
        dataset.set_epoch(epoch)
    device = next(state.objective.parameters()).device
    keys, sums, total_n, count = None, None, 0, 0
    for batch in batch_iterator(dataset, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
                                drop_last=train, skip=skip):
        n = len(batch['igt'])
        tensors = to_device(batch, device)
        metrics = step(state, tensors) if train else step(state, tensors)[0]
        if on_step is not None:
            on_step(metrics)
        if keys is None:
            keys = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in keys]) * n
        sums = vec if sums is None else sums + vec
        total_n += n
        count += 1
        if max_batches is not None and count >= max_batches:
            break
    if keys is None:
        return {}
    return {k: float(v) / total_n for k, v in zip(keys, sums.tolist())}


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint to resume from under `ckpt_dir`: the rolling 'last'
    when it exists, else the newest `best_*`; None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    last = os.path.join(ckpt_dir, 'last')
    if os.path.exists(os.path.join(last, checkpoint.TRAIN_STATE)):
        return last
    found = [(os.path.getmtime(os.path.join(ckpt_dir, n, checkpoint.TRAIN_STATE)),
              os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, n, checkpoint.TRAIN_STATE))]
    return max(found)[1] if found else None


def _log(f, record: Dict) -> None:
    f.write(json.dumps({k: (float(v) if isinstance(v, torch.Tensor) else v)
                        for k, v in record.items()}) + '\n')
    f.flush()


def fit(cfg: Config, *, log_dir: str = 'runs', max_steps: Optional[int] = None,
        datasets=None, resume: Optional[str] = None, init: Optional[str] = None,
        pretrain_feats: Optional[str] = None,
        device: str | torch.device = 'cuda') -> tuple[TrainState, Dict[str, float]]:
    """A training run; returns the final state and the last val metrics.

    `datasets` can inject (train, val); `max_steps` caps the optimizer steps
    of the run (counted from a resumed step); `init` starts from a
    checkpoint of the model (exported, or a train checkpoint directory);
    `pretrain_feats` then replaces the model's `feature_extraction`,
    parameters and BatchNorm statistics, by a feats checkpoint's (a stage
    directory of `train.feats_loop.fit_feats`, or an exported `.npz`;
    `train.feats.transplant_backbone`); `resume` restores a train
    checkpoint (model, optimizer, step, epoch, best metrics), 'auto' the
    newest under `<log_dir>/<ckpt_dir>`, and continues at its step,
    mid-epoch too.
    Writes one JSON line per train step and per validation to
    `<log_dir>/metrics.jsonl`, and checkpoints `best_<metric>` on each
    improvement and `last` after every epoch.
    """
    train_ds = datasets[0] if datasets else load_dataset(cfg.data, 'train')
    val_ds = datasets[1] if datasets else load_dataset(cfg.data, 'val')
    bs = cfg.data.batch_size
    steps_per_epoch = max(1, len(train_ds) // bs)
    state = create_state(cfg, steps_per_epoch, device=device, init=init)
    if pretrain_feats:
        from .feats import transplant_backbone
        model = state.objective.model
        model.load_state_dict(transplant_backbone(checkpoint.read(pretrain_feats)[1],
                                                  model.state_dict()), strict=True)
    ckpt_dir = os.path.join(log_dir, cfg.train.ckpt_dir)
    if resume == 'auto':
        resume = latest_checkpoint(ckpt_dir)
    if resume:
        checkpoint.restore_train(resume, state)
    train_step, eval_step = make_train_step(cfg.train.watch), make_eval_step()
    os.makedirs(log_dir, exist_ok=True)
    val_metrics: Dict[str, float] = {}
    start_epoch = min(state.step // steps_per_epoch, cfg.train.epochs)
    with open(os.path.join(log_dir, 'metrics.jsonl'), 'a') as log:
        for epoch in range(start_epoch, cfg.train.epochs):
            if max_steps is not None and state.step >= max_steps:
                break
            t0 = time.time()
            train_metrics = run_epoch(
                train_ds, train_step, state, bs, train=True, shuffle=True,
                seed=cfg.train.seed, epoch=epoch,
                skip=max(0, state.step - epoch * steps_per_epoch),
                max_batches=None if max_steps is None else max_steps - state.step,
                on_step=lambda m: _log(log, {'split': 'train', 'epoch': epoch,
                                             'step': state.step, **m}))
            state.epoch = epoch
            if (epoch + 1) % cfg.train.val_every == 0:
                val_metrics = run_epoch(val_ds, eval_step, state, bs, train=False,
                                        shuffle=False, seed=cfg.train.seed, epoch=epoch)
                _log(log, {'split': 'val', 'epoch': epoch, 'step': state.step,
                           'seconds': time.time() - t0, **val_metrics})
            tracked = {
                'train_loss': train_metrics.get('loss', math.inf),
                'val_loss': val_metrics.get('loss', math.inf),
                'rre': val_metrics.get('rre', math.inf),
                'rte': val_metrics.get('rte', math.inf),
                'rot_err': sum(val_metrics.get(f'rot_err_{a}', math.inf) for a in 'xyz') / 3,
                'trans_err': sum(val_metrics.get(f'trans_err_{a}', math.inf) for a in 'xyz') / 3,
            }
            for name, value in tracked.items():
                if value < state.best[name]:
                    state.best[name] = value
                    checkpoint.save_train(os.path.join(ckpt_dir, f'best_{name}'), state, cfg)
            checkpoint.save_train(os.path.join(ckpt_dir, 'last'), state, cfg)
            if max_steps is not None and state.step >= max_steps:
                break
    return state, val_metrics
