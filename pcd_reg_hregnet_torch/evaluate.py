"""Evaluate an exported checkpoint over a split (the port's counterpart of
the JAX package's `eval` sub-command).

    python -m pcd_reg_hregnet_torch.evaluate --weights port_assets/r5_v11_knn_best_rre.npz \\
        --split test [--icp point_to_plane] [--results out.json] [--device cpu]

The configuration is the checkpoint's own (`meta.json`); runs on the card
unless `--device cpu`.  Prints the summary of the last layer.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .eval.runner import evaluate
from .utils import checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser('python -m pcd_reg_hregnet_torch.evaluate')
    ap.add_argument('--weights', default=str(checkpoint.FLAGSHIP),
                    help='exported checkpoint (.npz beside its .meta.json)')
    ap.add_argument('--split', default='test', choices=('val', 'test'))
    ap.add_argument('--icp', default=None, choices=('point_to_point', 'point_to_plane'))
    ap.add_argument('--icp-iters', type=int, default=30)
    ap.add_argument('--results', default=None, help='write the results JSON here')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    cfg = checkpoint.load_config(args.weights)
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
