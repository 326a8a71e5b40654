"""What the bf16 path's reproduction of the JAX package's rounding costs a
forward on the card.

The port computes a few bf16 ops as the JAX package's compiled CPU
reference rounds them, so that its layers agree with the reference to a
rounding: `models.layers.softmax` (exponentials and their sum rounded
apart), `models.layers.mul_sum` and `ops.neighbors._sum_sq` (a sum of
products rounded once), `models.layers.Dense(upcast=True)` (a bias added
in f32 where an f32 consumer reads it), `models.ptv3._gelu` (op by op) and
the KnnCPE mean (rounded once).  This script serves the flagship
(`port_assets/r5_v11_knn_best_rre.npz`) in bf16 at B=8 x 8096 points,
with those rules and with plain torch ops in their place (one rounding
each), in turns (rules, plain, plain, rules), and prints per variant the
median synced forward (host clock), the device busy time and the device
ops per forward (torch.profiler), and how far the plain variant's poses
lie from the rules'.

    python tools/bf16_emulation_cost.py [--reps 10]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@contextlib.contextmanager
def plain_ops():
    """The bf16 rules replaced by plain torch ops (one rounding each)."""
    from pcd_reg_hregnet_torch.models import layers, ptv3
    from pcd_reg_hregnet_torch.ops import neighbors

    saved = (layers.softmax, layers.mul_sum, layers.Dense.forward, ptv3._gelu,
             ptv3.KnnCPE.forward, neighbors._sum_sq)
    dense = layers.Dense.forward

    def knn_cpe(self, x, nbr_idx, rel):
        h = neighbors.knn_gather(x, nbr_idx)
        w = self.Dense_1(ptv3._gelu(self.Dense_0(rel)))
        return torch.mean(h * w.to(h.dtype), dim=2)

    layers.softmax = lambda x, dim: torch.softmax(x, dim=dim)
    layers.mul_sum = lambda a, b, dim, keepdim=False: torch.sum(a * b, dim=dim, keepdim=keepdim)
    layers.Dense.forward = lambda self, x, upcast=False: dense(self, x)
    ptv3._gelu = lambda x: F.gelu(x, approximate='tanh')
    ptv3.KnnCPE.forward = knn_cpe
    neighbors._sum_sq = lambda x: torch.sum(x * x, dim=-1, keepdim=True)
    try:
        yield
    finally:
        (layers.softmax, layers.mul_sum, layers.Dense.forward, ptv3._gelu,
         ptv3.KnnCPE.forward, neighbors._sum_sq) = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA device', file=sys.stderr)
        return 1
    from pcd_reg_hregnet_torch import serve
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.utils import checkpoint

    model = zoo.build('model_v6', device='cuda', weights=checkpoint.FLAGSHIP,
                      compute_dtype='bfloat16')
    rng = np.random.default_rng(7)
    batch = [chip_smoke.make_clouds(rng, chip_smoke.N_POINTS) for _ in range(chip_smoke.BATCH)]
    src = torch.from_numpy(np.stack([s for s, _ in batch])).cuda()
    dst = torch.from_numpy(np.stack([d for _, d in batch])).cuda()

    def forward():
        return serve.register(model, src, dst, device='cuda')

    def measure():
        forward()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            t = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        host_ms, busy_ms, ops, _ = chip_smoke.profile_window(torch, forward, 2)
        out = forward()
        return {'median_ms': float(np.median(times)), 'busy_ms': busy_ms, 'ops': ops,
                'profiled_host_ms': host_ms}, out

    runs = {'rules': [], 'plain': []}
    poses = {}
    for variant in ('rules', 'plain', 'plain', 'rules'):
        with plain_ops() if variant == 'plain' else contextlib.nullcontext():
            numbers, out = measure()
        runs[variant].append(numbers)
        poses[variant] = out
        print(variant, json.dumps(numbers), flush=True)
    dt = float((poses['plain']['translation'] - poses['rules']['translation']).abs().max())
    dr = float((poses['plain']['rotation'] - poses['rules']['rotation']).abs().max())
    print(json.dumps({'rules': runs['rules'], 'plain': runs['plain'],
                      'plain_vs_rules_max_dR': dr, 'plain_vs_rules_max_dt_m': dt,
                      'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': chip_smoke.nvidia_smi()}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
