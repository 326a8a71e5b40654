"""How often the port picks other keypoints than the JAX package on the same
inputs: a trained checkpoint's forward in both packages on the CPU.

Runs the JAX `RegistrationModel` and the port's model on the JAX data
pipeline's first `--pairs` synthetic test pairs (bit-identical inputs in
both) and on the port's own pipeline's (its decalibrated source differs
from JAX's by f32 rounding, ~1e-5 m), and prints per pair the largest
keypoint deviation at each level (above 1e-3 m: another point was picked,
a near-tie) and the largest rotation-entry deviation of each level's pose,
then how many pairs pick another point at some level.

    JAX_PLATFORMS=cpu python tools/probe_near_ties.py [--weights port_assets/r4_v11_warm_best_rre.npz] [--pairs 24]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KEYPOINT_TOL = 1e-3   # m: a larger deviation is another point


def main() -> int:
    import jax
    import jax.numpy as jnp
    from pcd_reg_hregnet_tpu.core.config import Config as JConfig
    from pcd_reg_hregnet_tpu.data import batch_iterator as jbatches
    from pcd_reg_hregnet_tpu.data import load_dataset as jload
    from pcd_reg_hregnet_tpu.models.registration import RegistrationModel as JModel
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.utils import checkpoint

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--weights', default=str(checkpoint.WARM))
    ap.add_argument('--pairs', type=int, default=24)
    ap.add_argument('--threads', type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    with open(checkpoint.meta_path(args.weights)) as f:
        jcfg = JConfig.from_json(json.load(f)['config'])
    variables = checkpoint.load_variables(args.weights)
    variables = {'params': variables['params'], 'batch_stats': variables['batch_stats']}
    jmodel = JModel(jcfg.model)
    japply = jax.jit(lambda v, s, d: jmodel.apply(v, s, d, train=False))
    cfg = checkpoint.load_config(args.weights)
    model = zoo.build(cfg.model.name, device='cpu', weights=args.weights)
    jds = jload(jcfg.data, 'test')
    jds.table                      # the whole split's table, before any cut
    jds.source.length = args.pairs
    ds = load_dataset(cfg.data, 'test', length=args.pairs)
    bs = cfg.data.batch_size
    picked = {'same inputs': 0, 'own inputs': 0}
    pair = 0
    for jb, b in zip(jbatches(jds, bs, drop_last=False), batch_iterator(ds, bs, drop_last=False)):
        jo = japply(variables, jnp.asarray(jb['uncalibed_pcd']), jnp.asarray(jb['pcd_left']))
        with torch.no_grad():
            outs = {'same inputs': model(torch.from_numpy(jb['uncalibed_pcd']),
                                         torch.from_numpy(jb['pcd_left'])),
                    'own inputs': model(torch.from_numpy(b['uncalibed_pcd']),
                                        torch.from_numpy(b['pcd_left']))}
        for i in range(len(jb['igt'])):
            row = []
            for what, o in outs.items():
                kp = [max(float(np.abs(np.asarray(jo[f'{s}_feats'][f'xyz_{lvl}'][i])
                                       - o[f'{s}_feats'][f'xyz_{lvl}'][i].numpy()).max())
                          for s in ('src', 'dst')) for lvl in (1, 2, 3)]
                dR = [float(np.abs(np.asarray(jo['rotation'][k][i])
                                   - o['rotation'][k][i].numpy()).max()) for k in range(3)]
                picked[what] += max(kp) > KEYPOINT_TOL
                row.append(f'{what}: keypoints L1/L2/L3 {kp[0]:.1e}/{kp[1]:.1e}/{kp[2]:.1e} m, '
                           f'|dR| L3/L2/L1 {dR[0]:.1e}/{dR[1]:.1e}/{dR[2]:.1e}')
            print(f'pair {pair}: ' + ' | '.join(row), flush=True)
            pair += 1
    print(f'{pair} pairs of {args.weights}; pairs with another keypoint (> {KEYPOINT_TOL} m) '
          f'at some level: ' + ', '.join(f'{k} {v}' for k, v in picked.items()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
