"""The port's feats losses of the exported descriptor checkpoint against
the JAX package's CPU values, pair for pair.

Runs `chip_smoke.feats_yardstick_run` (the port's `FeatsObjective` at eval
on the yardstick's synthetic test pairs, per pair the losses of each level)
on a device and prints, per loss term, the largest relative deviation from
`port_assets/feats_desc_r5_feats_jax_cpu.json`, the pairs whose level-3
keypoints differ (a weighted-FPS near-tie), and how many pairs lie outside
each of a few relative tolerances.

    python tools/compare_feats.py [--device cpu|cuda] [--pairs N] [--threads N]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--pairs', type=int, default=None)
    ap.add_argument('--threads', type=int, default=None)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    t = time.perf_counter()
    got, ref = chip_smoke.feats_yardstick_run(torch, args.device, args.pairs)
    rel, same = chip_smoke.feats_deviation(got, ref)
    print(f'{len(rel)} pairs on {args.device} ({torch.get_num_threads()} threads) in '
          f'{time.perf_counter() - t:.1f} s')
    for j, k in enumerate(chip_smoke.FEATS_TERMS):
        i = int(np.argmax(rel[:, j]))
        print(f'{k}: mean {got[k].mean():.6f} vs {ref[k].mean():.6f}; max rel {rel[i, j]:.2e} '
              f'(pair {i}: {got[k][i]:.6f} vs {ref[k][i]:.6f}), median {np.median(rel[:, j]):.2e}')
    print(f'pairs with other level-3 keypoints: {np.flatnonzero(~same).tolist()}; outside '
          f'{chip_smoke.FEATS_PAIR_RTOL:g} with JAX\'s: '
          f'{np.flatnonzero((rel > chip_smoke.FEATS_PAIR_RTOL).any(1) & same).tolist()}')
    for tol in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2):
        print(f'rel tol {tol:g}: {np.flatnonzero((rel > tol).any(1)).tolist()} outside')
    return 0


if __name__ == '__main__':
    sys.exit(main())
