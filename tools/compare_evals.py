"""Compare eval results files pair for pair, layer for layer.

Each file is a results JSON of `evaluate` (either package) over the same
split.  For every two files and every layer both hold, prints how many
pairs put a pose outside the card-vs-CPU gate (rotation entries 1e-3,
translation 1e-2 m; `--tol R T` sets another), which pairs, the largest
deviations, and each file's rre_deg, rte_m and recall.  Poses are rebuilt from `pred_calib`.  Then
the spread of the summary: the standard deviation of the mean of the
per-pair differences d of rre, rte and the recall's success flag,
sqrt(sum d^2) / n, the noise a summary gate must hold a correct
implementation through.

    python tools/compare_evals.py port_assets/v11_r5_eval_jax_cpu.json card.json cpu.json
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcd_reg_hregnet_torch.eval.calib_eval import pose_deviation  # noqa: E402

TOL_R, TOL_T = 1e-3, 1e-2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('files', nargs='+')
    ap.add_argument('--tol', type=float, nargs=2, default=(TOL_R, TOL_T), metavar=('R', 'T'),
                    help='the per-pair gate: rotation entries, translation m')
    args = ap.parse_args()
    tol_r, tol_t = args.tol
    results = {}
    for path in args.files:
        with open(path) as f:
            results[path] = json.load(f)
    for a, b in itertools.combinations(args.files, 2):
        for name, (dR, dt) in pose_deviation(results[a], results[b]).items():
            bad = np.flatnonzero((dR > tol_r) | (dt > tol_t))
            la, lb = results[a][name], results[b][name]
            print(f'{a} vs {b} {name}: {len(bad)} of {len(dR)} pairs outside {bad.tolist()}; '
                  f'max |dR| {dR.max():.2e}, max |dt| {dt.max():.2e} m, median |dR| '
                  f'{np.median(dR):.2e}; rre_deg {np.mean(la["rre"]):.5f} / '
                  f'{np.mean(lb["rre"]):.5f}, rte_m {np.mean(la["rte"]):.5f} / '
                  f'{np.mean(lb["rte"]):.5f}, recall {la["recall"]:.4f} / {lb["recall"]:.4f}')
            sd = {k: float(np.sqrt(np.sum(d * d)) / len(d)) for k, d in (
                ('rre', np.subtract(la['rre'], lb['rre'])),
                ('rte', np.subtract(la['rte'], lb['rte'])),
                ('recall', success(la).astype(float) - success(lb)))}
            print(f'  {name}: sd of the mean difference: rre {sd["rre"]:.5f} deg, rte '
                  f'{sd["rte"]:.5f} m, recall {sd["recall"]:.5f}')
    return 0


def success(layer: dict, rot_deg: float = 1.0, trans_m: float = 0.1) -> np.ndarray:
    """Each pair's recall success: mean |per-axis| errors below the
    evaluator's thresholds (`eval/calib_eval.py`)."""
    e = np.abs(np.asarray(layer['error_calib']))
    return (e[:, :3].mean(1) < rot_deg) & (e[:, 3:].mean(1) < trans_m)


if __name__ == '__main__':
    sys.exit(main())
