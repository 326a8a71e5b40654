"""Train a registration model (the port's counterpart of the JAX package's
`train` sub-command).

    python -m pcd_reg_hregnet_torch.train --experiment reg_v11 --dataset synthetic|man|audi \\
        [--data-path DIR] \\
        [--batch-size 8 --epochs N --lr LR --max-steps N --init PATH --pretrain-feats PATH \\
         --resume PATH|auto --log-dir DIR --device cuda|cpu --npoints N --debug-scale --watch \\
         --compute-dtype float32|bfloat16 --ptv3-cpe knn|curve|none --ptv3-grid-size S]

The same command as `python -m pcd_reg_hregnet_torch train` (`cli.py`),
which parses its options with `add_train_args` too; under a launcher
(torchrun, or the JAX package's COORDINATOR_ADDRESS / PROCESS_COUNT /
PROCESS_INDEX) every rank runs it and `fit` trains data parallel.

Every experiment of the table runs (`reg_v0`-`reg_v13`, `baseline`,
`man_registration`; `feats`/`feats_desc` train the registration objective
of their table entry, as the JAX package's `train` does).  The feats
pretrain itself, detector then descriptor stage, is
`python -m pcd_reg_hregnet_torch.train.feats`; `--pretrain-feats` takes
its stage checkpoint (`<log-dir>/ckpt/feats_descriptor`) or an exported
one (`port_assets/r5_feats_desc_feats_descriptor.npz`) and starts the
model's `feature_extraction` from it.  Runs on the card unless `--device
cpu`.  `--init` starts from a checkpoint that records the experiment's
model: an exported one (`port_assets/r5_v11_knn_best_rre.npz`: reg_v11;
`port_assets/r4_v6_50_best_rre.npz`: reg_v6, MI discriminators included)
or a train checkpoint directory.  `--npoints` and `--debug-scale`
(64/32/16 keypoints, one PTv3 block, patches of 16) make a run small
enough for the CPU.  `--compute-dtype bfloat16` trains in the JAX
package's bf16 policy (parameters and optimizer state f32).  `--resume`
takes the model config (compute dtype included) from the checkpoint, the
options on top.  Writes one JSON line per step and per validation to
`<log-dir>/metrics.jsonl`, checkpoints under `<log-dir>/ckpt/`, and prints
a JSON summary.  `--dataset man` / `audi` read a MAN TruckScenes / A2D2
tree under `--data-path`; its val twist table is read from there, or drawn
by the port and written there where missing (`data/pipeline.py`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..utils import checkpoint
from .experiments import add_config_args, config_from_args, experiment
from .loop import fit, latest_checkpoint


def add_train_args(ap, log_dir: str = 'runs/torch') -> None:
    """The train command's options: `experiments.add_config_args` and the run's own."""
    add_config_args(ap)
    ap.add_argument('--init', default=None, help='checkpoint to start from')
    ap.add_argument('--pretrain-feats', default=None,
                    help='feats checkpoint to start the feature extraction from')
    ap.add_argument('--resume', default=None, help="train checkpoint directory, or 'auto'")
    ap.add_argument('--log-dir', default=log_dir)


def run(args) -> int:
    """Train as `args` (of `add_train_args`) say; prints a JSON summary."""
    # a resumed run's model config comes from its checkpoint, the options on
    # top (compute dtype included), as the JAX CLI's `train --resume` does
    resume = args.resume
    if resume == 'auto':
        resume = latest_checkpoint(os.path.join(
            args.log_dir, experiment(args.experiment).train.ckpt_dir))
    model_base = checkpoint.load_config(resume).model if resume else None
    cfg = config_from_args(args, model_base=model_base)
    t = time.perf_counter()
    state, val = fit(cfg, log_dir=args.log_dir, max_steps=args.max_steps, resume=args.resume,
                     init=args.init, pretrain_feats=args.pretrain_feats, device=args.device)
    print(json.dumps({'experiment': args.experiment, 'step': state.step, 'epoch': state.epoch,
                      'seconds': round(time.perf_counter() - t, 2), 'val': val,
                      'best': state.best}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser('python -m pcd_reg_hregnet_torch.train')
    add_train_args(ap)
    return run(ap.parse_args(argv))


if __name__ == '__main__':
    sys.exit(main())
