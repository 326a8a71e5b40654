"""Times of patch attention (kernel K3) at the serving forward's shapes.

    python3 -m pcd_reg_hregnet_torch.time_attention [--reps 20]

For each [R, H, K, d] of the `model_v6` forward (patch sizes 256/128/64,
channels 64/128/256, heads 2/4/8) at B=8 and B=1 (R = 4B), f32 and bf16,
prints one JSON line: `call_ms`, the time of one
`ops.kernels.attention.patch_attention` call when calls are issued back
to back from Python (CUDA events around them; the host's time per call
shows where it exceeds the kernel's); `ms`, its device time (`reps`
launches captured in a CUDA graph and replayed, so no host time is in
it); and `plain_ms`, the plain version's device time.  It uses only the
public `patch_attention(q, k, v, scale)`, so copied into another
checkout's package it times that checkout's kernel the same way (the A/B
of PERF.md).  `chip_smoke.py` times K3 with the same two functions at the
same shapes.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import torch

from .core.device import fp32_numerics
from .ops.kernels import attention as kattn

LEVELS = ((256, 64), (128, 128), (64, 256))   # (patch K, channels C)
HEADS = (2, 4, 8)


def shapes(B: int) -> list:
    """[R, H, K, d] of K3's launches in a forward of B pairs (each twice
    per tower: two PTv3 blocks per stage)."""
    return [(4 * B, H, K, C // H) for K, C in LEVELS for H in HEADS]


def device_ms(fn, reps: int) -> float:
    """Device time of one `fn()` in ms: `reps` calls captured in a CUDA
    graph, replayed after a warm-up, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def call_ms(fn, reps: int) -> float:
    """Time of one `fn()` in ms as issued back to back from Python."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('time_attention needs a CUDA device')
    gen = torch.Generator().manual_seed(0)
    with fp32_numerics():
        for B in (8, 1):
            for R, H, K, d in shapes(B):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (torch.randn((R, H, K, d), generator=gen).to('cuda', dtype)
                               for _ in range(3))
                    s = d ** -0.5
                    print(json.dumps({
                        'B': B, 'K': K, 'd': d, 'H': H, 'dtype': str(dtype)[6:],
                        'ms': device_ms(lambda: kattn.patch_attention(q, k, v, s),
                                        args.reps),
                        'call_ms': call_ms(lambda: kattn.patch_attention(q, k, v, s),
                                           args.reps),
                        'plain_ms': device_ms(lambda: kattn.patch_attention_reference(
                            q, k, v, s), args.reps)}), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
