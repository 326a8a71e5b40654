"""Trace where the port and the JAX package pick different keypoints.

For one pair of the synthetic test split, runs the JAX model and the port
(both on the CPU, the flagship checkpoint, the pair's whole B=8 batch as
the eval runs it, on the JAX package's input arrays), prints each level's
pose difference, the first keypoint each tower's pyramid picks
differently, and at that weighted-FPS step the two best candidates'
scores under each package's sigmas: a relative gap below the sigmas'
relative difference is a near-tie that last-bit rounding decides.

    JAX_PLATFORMS=cpu python tools/trace_fps_tie.py 18
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wfps_scores(xyz: np.ndarray, sigma: np.ndarray, steps: int) -> np.ndarray:
    """Running weighted distances after `steps` weighted-FPS steps (f32)."""
    w = 1.0 / (sigma + 1e-5)
    w = (w / w.mean()).astype(np.float32)
    temp = np.full(len(xyz), 1e10, np.float32)
    last = 0
    for _ in range(steps):
        temp = np.minimum(temp, ((xyz - xyz[last]) ** 2).sum(1).astype(np.float32) * w)
        last = int(np.argmax(temp))
    return temp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('pair', type=int)
    args = ap.parse_args()

    import jax
    import torch
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.utils import checkpoint
    from pcd_reg_hregnet_tpu.core.config import Config
    from pcd_reg_hregnet_tpu.data import load_dataset
    from pcd_reg_hregnet_tpu.models.registration import RegistrationModel

    with open(checkpoint.meta_path(checkpoint.FLAGSHIP)) as f:
        cfg = Config.from_json(json.load(f)['config'])
    bs = cfg.data.batch_size
    start, row = args.pair // bs * bs, args.pair % bs
    ds = load_dataset(cfg.data, 'test')
    items = [ds[i] for i in range(start, start + bs)]
    src = np.stack([it['uncalibed_pcd'] for it in items])
    dst = np.stack([it['pcd_left'] for it in items])
    jm = RegistrationModel(cfg.model)
    jout = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        checkpoint.load_variables(checkpoint.FLAGSHIP), src, dst)
    tm = zoo.build('model_v6', device='cpu', weights=checkpoint.FLAGSHIP)
    with torch.no_grad():
        tout = tm(torch.from_numpy(src), torch.from_numpy(dst))
    for lvl in range(3):
        dR = np.abs(tout['rotation'][lvl][row].numpy() - np.asarray(jout['rotation'][lvl][row])).max()
        dt = np.abs(tout['translation'][lvl][row].numpy()
                    - np.asarray(jout['translation'][lvl][row])).max()
        print(f'level {3 - lvl}: port vs JAX max |dR| {dR:.2e}, max |dt| {dt:.2e} m')
    for tower in ('src_feats', 'dst_feats'):
        for lvl in (1, 2, 3):
            a = np.asarray(jout[tower][f'xyz_{lvl}'][row])
            b = tout[tower][f'xyz_{lvl}'][row].numpy()
            diff = np.flatnonzero(np.abs(a - b).max(1) > 1e-4)
            print(f'{tower} L{lvl}: {len(diff)} of {len(a)} keypoints differ'
                  + (f', the first at step {diff[0]}' if len(diff) else ''))
            if not len(diff) or lvl == 1:
                continue
            xyz = np.asarray(jout[tower][f'xyz_{lvl - 1}'][row]).astype(np.float32)
            j_sig = np.asarray(jout[tower][f'sigmas_{lvl - 1}'][row])
            t_sig = tout[tower][f'sigmas_{lvl - 1}'][row].numpy()
            for name, sig in (('JAX', j_sig), ('port', t_sig)):
                temp = wfps_scores(xyz, sig, int(diff[0]))
                top = np.argsort(-temp)[:2]
                print(f'  {name} sigmas: best two scores {temp[top]}, relative gap '
                      f'{(temp[top[0]] - temp[top[1]]) / temp[top[0]]:.2e}; sigma relative '
                      f'difference there {np.abs(t_sig[top] - j_sig[top]) / np.abs(j_sig[top])}')
            break
    return 0


if __name__ == '__main__':
    sys.exit(main())
