"""Where the serving forward spends its time on one GPU.

    python3 -m pcd_reg_hregnet_torch.profile_serve [--batch 8]

Builds `model_v6` at full width with seeded random weights, runs REPS
forwards of `serve.register` on `batch` random 8096-point pairs under
`torch.profiler`, and prints: host ms per forward, device busy ms per
forward (the union of kernel intervals) and its share of the window, and
the TOP kernels that took the most device time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import serve
from .models import zoo

REPS = 3    # profiled forwards after one warm-up
TOP = 15    # kernels listed


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_serve needs a CUDA device')

    model = zoo.build('model_v6', device='cuda', seed=0)
    rng = np.random.default_rng(0)
    dst = torch.from_numpy(rng.uniform(-40, 40, (args.batch, 8096, 3)).astype(np.float32)).cuda()
    src = dst + 0.3
    serve.register(model, src, dst, device='cuda')       # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            serve.register(model, src, dst, device='cuda')
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / REPS * 1e3

    dev = _device_events(prof)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev)
    per_kernel: dict[str, list[float]] = {}
    for e in dev:
        per_kernel.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    print(f'{torch.cuda.get_device_name(0)}: model_v6 B={args.batch}, {REPS} forwards')
    print(f'host {host_ms:.2f} ms/forward; device busy {busy_us / 1e3 / REPS:.2f} '
          f'ms/forward ({busy_us / 1e3 / REPS / host_ms:.1%} of the window); '
          f'{len(dev) / REPS:.0f} device ops/forward')
    rows = sorted(per_kernel.items(), key=lambda kv: -sum(kv[1]))[:TOP]
    for name, times in rows:
        print(f'  {sum(times) / 1e3 / REPS:8.3f} ms/forward  {len(times) // REPS:5d}x  '
              f'{name[:110]}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
