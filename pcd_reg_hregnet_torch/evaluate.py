"""Evaluate a checkpoint over a split (the port's counterpart of the JAX
package's `eval` sub-command).

    python -m pcd_reg_hregnet_torch.evaluate --weights port_assets/r5_v11_knn_best_rre.npz \\
        --split test [--icp point_to_plane] [--results out.json] [--device cpu] \\
        [--compute-dtype bfloat16] [--dataset man --data-path /data/truckscenes]

`--weights` takes any exported checkpoint (default the flagship, reg_v11;
`port_assets/r4_v6_50_best_rre.npz` is reg_v6, model_v2;
`port_assets/r4_v11_warm_best_rre.npz` is reg_v11 warm-started from the
feats pretrain) or a train checkpoint directory the port wrote
(`runs/torch/ckpt/best_rre`).  The
configuration is the checkpoint's own (`meta.json`), with
`--compute-dtype` overriding the one it records (`bfloat16` serves an
f32-trained checkpoint in the JAX package's bf16 policy), and `--dataset`
/ `--data-path` the data it records (`man`: a MAN TruckScenes tree,
`audi`: an A2D2 tree; a split's twist table missing under the path is
drawn by the port and written there).  Runs on the card unless `--device
cpu`.  Prints the summary of the last layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from .eval.runner import evaluate
from .utils import checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser('python -m pcd_reg_hregnet_torch.evaluate')
    ap.add_argument('--weights', default=str(checkpoint.FLAGSHIP),
                    help='exported checkpoint (.npz beside its .meta.json) or a train '
                         'checkpoint directory')
    ap.add_argument('--split', default='test', choices=('val', 'test'))
    ap.add_argument('--icp', default=None, choices=('point_to_point', 'point_to_plane'))
    ap.add_argument('--icp-iters', type=int, default=30)
    ap.add_argument('--results', default=None, help='write the results JSON here')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dataset', default=None, choices=('man', 'audi', 'synthetic'))
    ap.add_argument('--data-path', default=None,
                    help='root of the dataset\'s files (TruckScenes, A2D2) and of its twist '
                         'tables')
    ap.add_argument('--compute-dtype', default=None, choices=('float32', 'bfloat16'),
                    help='activation dtype of the compute path (for this model bfloat16 '
                         'is mainly an activation-memory knob: the hot spots are gathers '
                         'and sampling, not matmul throughput)')
    args = ap.parse_args(argv)

    cfg = checkpoint.load_config(args.weights)
    if args.compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=args.compute_dtype))
    data = {k: v for k, v in (('dataset', args.dataset), ('path', args.data_path))
            if v is not None}
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data))
    t = time.perf_counter()
    out = evaluate(cfg, args.weights, split=args.split, icp=args.icp,
                   icp_iters=args.icp_iters, results_path=args.results, device=args.device)
    seconds = time.perf_counter() - t
    pairs = len(out['layer_0']['rre'])
    print(json.dumps({'pairs': pairs, 'seconds': round(seconds, 2),
                      'pairs_per_s': round(pairs / seconds, 2), 'summary': out['summary']}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
