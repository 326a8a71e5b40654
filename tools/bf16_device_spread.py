"""How far the card's bf16 forward lies from the port's CPU bf16 forward, per
level: the yardstick for `chip_smoke.py`'s bf16_serve pose limits.

The flagship (`port_assets/r5_v11_knn_best_rre.npz`) in
`compute_dtype='bfloat16'`, on the first `--pairs` synthetic test pairs,
each prepared as the serve phase prepares its pair (range filter at 80 m,
resampled to 8096 points), one pair a forward (B=1), on the card and on
the CPU (`chip_smoke.CPU_THREADS` threads, as the serve phase's CPU
forward).  Per pair and level: max |dR| (rotation entries) and max |dt| (m)
between the two, and max |dxyz| of the level's keypoints.  Prints the
largest and the median of each per level and writes every pair's numbers
to `chiprun_out/bf16_device_spread.json`.

    python tools/bf16_device_spread.py [--pairs 12]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pairs', type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    from pcd_reg_hregnet_torch.data.pipeline import range_filter, resample
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.utils import checkpoint

    over = {'compute_dtype': 'bfloat16'}
    gpu = zoo.build('model_v6', device='cuda', weights=checkpoint.FLAGSHIP, **over)
    cpu = zoo.build('model_v6', device='cpu', weights=checkpoint.FLAGSHIP, **over)
    torch.set_num_threads(chip_smoke.CPU_THREADS)
    rows = []
    t0 = time.perf_counter()
    for i, raw in enumerate(chip_smoke.synthetic_pairs(args.pairs)):
        rng = np.random.default_rng(i)
        prep = []
        for pts in raw:
            pts, _ = range_filter(pts, 80.0)
            pts, _ = resample(pts, chip_smoke.N_POINTS, rng)
            prep.append(torch.from_numpy(pts[None]))
        with torch.no_grad():
            out_c = cpu(*prep)
            out_g = gpu(*(p.cuda() for p in prep))
        row = {'pair': i}
        for j, lvl in enumerate((3, 2, 1)):   # the model's poses, coarse to fine
            row[f'L{lvl}_dR'] = float((out_g['rotation'][j].cpu()
                                       - out_c['rotation'][j]).abs().max())
            row[f'L{lvl}_dt'] = float((out_g['translation'][j].cpu()
                                       - out_c['translation'][j]).abs().max())
            row[f'L{lvl}_dxyz'] = max(
                float((out_g[s][f'xyz_{lvl}'].cpu() - out_c[s][f'xyz_{lvl}']).abs().max())
                for s in ('src_feats', 'dst_feats'))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in rows[0]:
        if key != 'pair':
            vals = np.array([r[key] for r in rows])
            summary[key] = {'max': float(vals.max()), 'median': float(np.median(vals))}
    smi = chip_smoke.nvidia_smi()
    out = {'pairs': len(rows), 'seconds': time.perf_counter() - t0, 'summary': summary,
           'rows': rows, 'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi,
           'torch': torch.__version__}
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'bf16_device_spread.json'), 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps({'pairs': len(rows), 'summary': summary}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
