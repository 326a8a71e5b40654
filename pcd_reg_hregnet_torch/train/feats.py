"""Feature pretraining: the detector stage, then the descriptor stage (port
of `pcd_reg_hregnet_tpu/train/feats.py`), and its command line.

    python -m pcd_reg_hregnet_torch.train.feats --stage detector --batch-size 16 \\
        [--epochs N --max-steps N --log-dir DIR --device cuda|cpu --npoints N --debug-scale]
    python -m pcd_reg_hregnet_torch.train.feats --stage descriptor --batch-size 8 \\
        --pretrain-detector DIR/ckpt/feats_detector

  stage 'detector':   the probabilistic chamfer loss of the three pyramid
                      levels, both clouds, after the ground-truth transform;
  stage 'descriptor': + the matching loss of each level, the detector frozen.

The backbone is the `HierFeatureExtraction` of the registration models, so
its pretrained weights warm-start registration training
(`python -m pcd_reg_hregnet_torch.train --pretrain-feats
DIR/ckpt/feats_descriptor`; `transplant_backbone`).  The config is built
as the JAX package's `pretrain-feats` builds it: the `--experiment`'s
(default `reg_v11`, so `model_v6`), then Adam at 1e-3, StepLR(10, 0.5)
and, in the descriptor stage, `freeze_detector`.  Runs on the card unless
`--device cpu`; writes one JSON line per step to `<log-dir>/metrics.jsonl`
and the stage checkpoint `<log-dir>/ckpt/feats_<stage>` after every epoch
and at the last step, and resumes from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict

import torch
from torch import nn

from ..core.config import Config
from ..core.device import fp32_numerics, resolve_device
from ..geometry import se3
from ..losses import matching_loss, prob_chamfer_loss
from ..models import zoo
from ..models.registration import HierFeatureExtraction
from .experiments import add_config_args, config_from_args
from .loop import TrainState
from .optimizer import Optimizer

SUBTREE = 'feature_extraction.'
STAGES = ('detector', 'descriptor')


class FeatsObjective(nn.Module):
    """`forward(batch)` -> (total loss, metrics, (ret_src, ret_dst)) for a
    batch of `uncalibed_pcd`, `pcd_left` [B, N, 3] and `igt` [B, 4, 4]: the
    extractor runs on src, then on dst (two calls: in train mode each has
    its own BatchNorm statistics and updates the running ones, in that
    order); per level `chamfer_l{i}` and, with `train_desc`,
    `matching_l{i}`; `loss` their sum.  Runs without TF32."""

    def __init__(self, cfg: Config, train_desc: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_desc = train_desc
        self.feature_extraction = HierFeatureExtraction(cfg.model)

    @fp32_numerics()
    def forward(self, batch: dict):
        gt_R, gt_t = se3.unpack(se3.inverse(batch['igt']))
        ret_src = self.feature_extraction(batch['uncalibed_pcd'])
        ret_dst = self.feature_extraction(batch['pcd_left'])
        metrics = {}
        total = torch.zeros((), dtype=torch.float32, device=gt_t.device)
        for lvl in (1, 2, 3):
            xyz, sig, desc = f'xyz_{lvl}', f'sigmas_{lvl}', f'desc_{lvl}'
            c = prob_chamfer_loss(ret_src[xyz], ret_dst[xyz], ret_src[sig], ret_dst[sig],
                                  gt_R, gt_t)
            metrics[f'chamfer_l{lvl}'] = c
            total = total + c
            if self.train_desc:
                m = matching_loss(ret_src[xyz], ret_src[sig], ret_src[desc],
                                  ret_dst[xyz], ret_dst[sig], ret_dst[desc], gt_R, gt_t)
                metrics[f'matching_l{lvl}'] = m
                total = total + m
        metrics['loss'] = total
        return total, metrics, (ret_src, ret_dst)


def create_feats_state(cfg: Config, steps_per_epoch: int, *, stage: str = 'detector',
                       device: str | torch.device = 'cuda') -> TrainState:
    """A fresh feats state on `device`: the objective of `stage`, its weights
    seeded from `cfg.train.seed` (`models.zoo.init_weights`), and the
    optimizer of `cfg.train` (its `freeze_detector` freezes every
    `detector` parameter)."""
    if stage not in STAGES:
        raise ValueError(f'unknown stage {stage!r}; one of {STAGES}')
    dev = resolve_device(device)
    objective = FeatsObjective(cfg, train_desc=stage == 'descriptor')
    zoo.init_weights(objective, torch.Generator().manual_seed(cfg.train.seed))
    objective.to(dev)
    return TrainState(objective, Optimizer(cfg.train, objective.named_parameters(),
                                           steps_per_epoch))


def transplant_backbone(feats_state: Dict[str, torch.Tensor],
                        model_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`model_state` with every `feature_extraction.*` entry, parameters and
    BatchNorm statistics, taken from `feats_state` (the warm start of the
    reference's `load_state_dict(strict=False)`).  Strict within the
    subtree: KeyError when either side has none, ValueError when the two
    subtrees differ in names or shapes."""
    have = {k: v for k, v in feats_state.items() if k.startswith(SUBTREE)}
    want = {k: v for k, v in model_state.items() if k.startswith(SUBTREE)}
    for side, sub in (('the pretrained state', have), ('the target state', want)):
        if not sub:
            raise KeyError(f'{side} has no feature_extraction subtree')
    if set(have) != set(want):
        raise ValueError('feature_extraction subtrees differ: missing '
                         f'{sorted(set(want) - set(have))[:4]}, unexpected '
                         f'{sorted(set(have) - set(want))[:4]}')
    shapes = [k for k in want if have[k].shape != want[k].shape]
    if shapes:
        raise ValueError(f'feature_extraction shapes differ: {shapes[:4]} '
                         f'{[(tuple(have[k].shape), tuple(want[k].shape)) for k in shapes[:4]]}')
    return {**model_state, **have}


def recipe(cfg: Config, stage: str) -> Config:
    """`cfg` with the pretrain recipe of `stage`: Adam at 1e-3, StepLR (the
    config's `step_size` / `step_gamma`, 10 / 0.5 by default), the detector
    frozen in the descriptor stage (the JAX package's `cli.py`
    `pretrain-feats`)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer='adam', schedule='step', lr=1e-3,
        freeze_detector=stage == 'descriptor'))


def add_feats_args(ap, log_dir: str = 'runs/torch_feats') -> None:
    """The pretrain command's options: `experiments.add_config_args` and the stage's own."""
    ap.add_argument('--stage', default='detector', choices=STAGES)
    ap.add_argument('--pretrain-detector', default=None,
                    help='feats checkpoint to start from (weights only, fresh optimizer): '
                         'the detector stage\'s directory, or an exported .npz')
    add_config_args(ap)
    ap.add_argument('--log-dir', default=log_dir)


def run(args) -> int:
    """Pretrain one stage as `args` (of `add_feats_args`) say; prints a JSON summary."""
    from .feats_loop import fit_feats
    cfg = recipe(config_from_args(args), args.stage)
    t = time.perf_counter()
    state, metrics = fit_feats(cfg, stage=args.stage, pretrain_detector=args.pretrain_detector,
                               log_dir=args.log_dir, max_steps=args.max_steps,
                               device=args.device)
    print(json.dumps({'stage': args.stage, 'experiment': args.experiment, 'step': state.step,
                      'epoch': state.epoch, 'seconds': round(time.perf_counter() - t, 2),
                      'train': metrics}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser('python -m pcd_reg_hregnet_torch.train.feats')
    add_feats_args(ap)
    return run(ap.parse_args(argv))


if __name__ == '__main__':
    sys.exit(main())
