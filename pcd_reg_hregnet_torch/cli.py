"""Command-line interface of the port (port of `pcd_reg_hregnet_tpu/cli.py`):

    python -m pcd_reg_hregnet_torch train --experiment reg_v11 --dataset man \\
        --data-path /data/truckscenes --epochs 100 [--lr 1e-4 --ptv3-cpe curve ...]
    python -m pcd_reg_hregnet_torch eval --ckpt runs/ckpt/best_rre --icp point_to_plane \\
        --results results/results.json
    python -m pcd_reg_hregnet_torch eval --icp-only --icp point_to_plane
    python -m pcd_reg_hregnet_torch infer --ckpt port_assets/r5_v11_knn_best_rre.npz \\
        --src a.npy --dst b.bin [--icp point_to_plane --out pose.json]
    python -m pcd_reg_hregnet_torch pretrain-feats --stage detector
    python -m pcd_reg_hregnet_torch visualize --results results/results.json

Every subcommand takes the JAX CLI's options (`train/experiments.py::
add_config_args`, the one parser the port's commands share) and
`--device cuda|cpu` (the card unless `--device cpu`).  `eval` and `infer`
take the model and loss config from the checkpoint (`--ckpt`: an exported
`.npz` or a train checkpoint directory), the options on top, as the JAX
CLI does.  `train` and `pretrain-feats` run the commands of
`python -m pcd_reg_hregnet_torch.train` and `.train.feats`; under a
launcher (torchrun, or COORDINATOR_ADDRESS / PROCESS_COUNT /
PROCESS_INDEX) `train` runs data parallel.  The JAX CLI's `bench` runs the
JAX harness and has no counterpart here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

_CLOUD_HELP = 'cloud file: .npy, .npz (key points, else the first) or a float32 .bin'


def _common(p: argparse.ArgumentParser) -> None:
    from .train.experiments import add_config_args
    add_config_args(p)
    p.add_argument('--log-dir', default='runs')


def _ckpt_config(ckpt_path):
    """The full Config a checkpoint records (an exported `.npz` beside its
    `.meta.json`, or a train checkpoint directory), or None."""
    from .utils import checkpoint
    if not ckpt_path or not checkpoint.meta_path(ckpt_path).exists():
        return None
    return checkpoint.load_config(ckpt_path)


def _build_config(args, model_base=None):
    """The experiment's Config with the options on top (`model_base`, a
    checkpoint's ModelConfig, first), as the JAX CLI's `_build_config`."""
    from .train.experiments import config_from_args
    return config_from_args(args, model_base=model_base)


def _ckpt_run_config(args):
    """`_build_config` over the checkpoint's model and loss config."""
    saved = _ckpt_config(getattr(args, 'ckpt', None))
    cfg = _build_config(args, model_base=None if saved is None else saved.model)
    return cfg if saved is None else dataclasses.replace(cfg, loss=saved.loss)


def load_cloud(path: str):
    """A point cloud [n, >=3] from .npy, .npz or a float32 .bin of x y z i
    (ring) rows (`data.truckscenes.load_lidar_bin`)."""
    import numpy as np
    if path.endswith('.npy'):
        return np.load(path)
    if path.endswith('.npz'):
        arrs = np.load(path)
        return arrs['points' if 'points' in arrs else list(arrs)[0]]
    from .data.truckscenes import load_lidar_bin
    return load_lidar_bin(path)[0]


def parser() -> argparse.ArgumentParser:
    from .train.__main__ import add_train_args
    from .train.feats import add_feats_args
    ap = argparse.ArgumentParser('pcd_reg_hregnet_torch')
    sub = ap.add_subparsers(dest='cmd', required=True)

    add_train_args(sub.add_parser('train', help='train a registration experiment'),
                   log_dir='runs')

    p_eval = sub.add_parser('eval', help='evaluate on the test split')
    _common(p_eval)
    p_eval.add_argument('--ckpt', default=None, help='required unless --icp-only')
    p_eval.add_argument('--icp', default=None, choices=['point_to_point', 'point_to_plane'])
    p_eval.add_argument('--icp-only', action='store_true',
                        help='classical ICP from the identity, no network')
    p_eval.add_argument('--icp-iters', type=int, default=None)
    p_eval.add_argument('--seq-parallel', type=int, default=0,
                        help='shard the PTv3 serialized point axis over N ranks (not ported '
                             'yet: values above 1 are refused)')
    p_eval.add_argument('--results', default='results/results.json')

    add_feats_args(sub.add_parser('pretrain-feats', help='detector/descriptor pretrain'),
                   log_dir='runs')

    p_inf = sub.add_parser('infer', help='register one source cloud onto a target cloud')
    _common(p_inf)
    p_inf.add_argument('--ckpt', required=True)
    p_inf.add_argument('--src', required=True, help='source ' + _CLOUD_HELP)
    p_inf.add_argument('--dst', required=True, help='target ' + _CLOUD_HELP)
    p_inf.add_argument('--icp', default=None, choices=['point_to_point', 'point_to_plane'])
    p_inf.add_argument('--out', default=None, help='write the pose JSON here')

    p_vis = sub.add_parser('visualize', help='plot suite from an eval results JSON')
    p_vis.add_argument('--results', required=True,
                       help='results JSON written by `eval --results ...`')
    p_vis.add_argument('--out', default='plots')
    p_vis.add_argument('--max-rot', type=float, default=2.0,
                       help='recall-curve rotation threshold sweep end [deg]')
    p_vis.add_argument('--max-trans', type=float, default=0.5,
                       help='recall-curve translation threshold sweep end [m]')
    return ap


def _eval(args) -> int:
    from .eval.runner import evaluate, evaluate_icp_only
    cfg = _ckpt_run_config(args)
    if args.icp_only:
        out = evaluate_icp_only(cfg, icp=args.icp or 'point_to_point',
                                icp_iters=args.icp_iters or 100,
                                results_path=args.results, device=args.device)
        print(out['summary'])
        return 0
    if not args.ckpt:
        print('--ckpt is required unless --icp-only', file=sys.stderr)
        return 2
    icp_iters = {} if args.icp_iters is None else {'icp_iters': args.icp_iters}
    out = evaluate(cfg, args.ckpt, icp=args.icp, results_path=args.results,
                   seq_parallel=args.seq_parallel, device=args.device, **icp_iters)
    print(out['summary'])
    return 0


def _infer(args) -> int:
    from .eval.runner import load_model
    from .serve import infer_pair
    cfg = _ckpt_run_config(args)
    model = load_model(cfg, args.ckpt, args.device)
    out = infer_pair(model, load_cloud(args.src), load_cloud(args.dst), device=args.device,
                     max_range=cfg.data.max_range, num_points=cfg.data.pcd_min_samples,
                     icp=args.icp)
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text)
    print(text)
    return 0


def _visualize(args) -> int:
    from .utils.visualize import VisualizeResults
    with open(args.results) as f:
        res = json.load(f)
    layers = {k: v for k, v in sorted(res.items())
              if k.startswith('layer_') and isinstance(v, dict)}
    if not layers:
        print(f'no layer_* entries in {args.results}', file=sys.stderr)
        return 1
    finest = layers[max(layers, key=lambda k: int(k.split('_')[-1]))]
    viz = VisualizeResults(args.out)
    paths = [viz.error_distributions(finest, 'finest'), viz.box_plots(layers),
             viz.recall_curve(finest, max_rot=args.max_rot, max_trans=args.max_trans)]
    if finest.get('rre'):
        paths.append(viz.rre_histogram(finest, 'finest'))
    print('\n'.join(paths))
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.cmd == 'train':
        from .train.__main__ import run
        return run(args)
    if args.cmd == 'pretrain-feats':
        from .train.feats import run
        return run(args)
    return {'eval': _eval, 'infer': _infer, 'visualize': _visualize}[args.cmd](args)


if __name__ == '__main__':
    sys.exit(main())
