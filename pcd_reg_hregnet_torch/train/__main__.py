"""Train a registration model (the port's counterpart of the JAX package's
`train` sub-command).

    python -m pcd_reg_hregnet_torch.train --experiment reg_v11 --dataset synthetic \\
        [--batch-size 8 --epochs N --max-steps N --init PATH --resume PATH|auto \\
         --log-dir DIR --device cuda|cpu --npoints N --debug-scale --watch]

Every experiment of the table runs (`reg_v0`-`reg_v13`, `baseline`,
`man_registration`; `feats`/`feats_desc` train the registration objective
of their table entry, as the JAX package's `train` does: their own
pretrain, `pretrain-feats`, is not ported yet).  Runs on the card
unless `--device cpu`.  `--init` starts from an exported checkpoint that
records the experiment's model (`port_assets/r5_v11_knn_best_rre.npz`:
reg_v11; `port_assets/r4_v6_50_best_rre.npz`: reg_v6, MI discriminators
included); `--npoints` and `--debug-scale` (64/32/16 keypoints, one PTv3
block, patches of 16) make a run small enough for the CPU.  Writes one JSON line per step
and per validation to `<log-dir>/metrics.jsonl`, checkpoints under
`<log-dir>/ckpt/`, and prints a JSON summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from ..core.config import LevelConfig
from .experiments import available, experiment
from .loop import fit


def build_config(args):
    cfg = experiment(args.experiment)
    data = {k: v for k, v in (('dataset', args.dataset), ('batch_size', args.batch_size),
                              ('pcd_min_samples', args.npoints)) if v is not None}
    train = {k: v for k, v in (('epochs', args.epochs), ('seed', args.seed)) if v is not None}
    if args.watch:
        train['watch'] = True
    model = {}
    if args.debug_scale:
        model = dict(levels=(LevelConfig(64, 16, (16, 16, 32), 32),
                             LevelConfig(32, 8, (32, 32, 64), 64),
                             LevelConfig(16, 8, (64, 64, 128), 128)),
                     ptv3_patch_sizes=(16, 16, 16), ptv3_depths=(1,), ptv3_num_heads=(2,))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data),
                               train=dataclasses.replace(cfg.train, **train),
                               model=dataclasses.replace(cfg.model, **model))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser('python -m pcd_reg_hregnet_torch.train')
    ap.add_argument('--experiment', default='reg_v11', choices=available())
    ap.add_argument('--dataset', default=None, choices=('man', 'audi', 'synthetic'))
    ap.add_argument('--batch-size', type=int, default=None)
    ap.add_argument('--epochs', type=int, default=None)
    ap.add_argument('--max-steps', type=int, default=None)
    ap.add_argument('--seed', type=int, default=None)
    ap.add_argument('--npoints', type=int, default=None, help='points per cloud')
    ap.add_argument('--debug-scale', action='store_true',
                    help='a small keypoint pyramid and PTv3 stack, for CPU runs')
    ap.add_argument('--watch', action='store_true', help='log per-module norms')
    ap.add_argument('--init', default=None, help='exported checkpoint to start from')
    ap.add_argument('--resume', default=None, help="train checkpoint directory, or 'auto'")
    ap.add_argument('--log-dir', default='runs/torch')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    cfg = build_config(args)
    t = time.perf_counter()
    state, val = fit(cfg, log_dir=args.log_dir, max_steps=args.max_steps, resume=args.resume,
                     init=args.init, device=args.device)
    print(json.dumps({'experiment': args.experiment, 'step': state.step, 'epoch': state.epoch,
                      'seconds': round(time.perf_counter() - t, 2), 'val': val,
                      'best': state.best}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
