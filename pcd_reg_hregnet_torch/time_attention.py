"""Times of patch attention (kernel K3) at the serving forward's shapes,
and of its backward (kernel K3b) at the train step's.

    python3 -m pcd_reg_hregnet_torch.time_attention [--reps 20] [--backward]

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
same shapes.

With `--backward`, for each shape at B=8 and B=1, f32 and bf16 (or the
dtypes of `--dtypes`): the backward of
`ops.kernels.attention.PatchAttentionFunction` alone (`torch.autograd.grad`
of a forward kept with `retain_graph`, which launches K3b and nothing
else), as device time (`ms`) and back to back (`call_ms`), and forward and
backward together (`fwd_bwd_ms`, `fwd_bwd_call_ms`); the host time of one
backward issued alone after a synchronize (`host_ms`, the median wall
time of 10 x `reps` calls), and the same of the public
`patch_attention_backward` alone on the same views (`wrapper_host_ms`);
and the gradient's
largest error against the plain backward's, over its largest value
(`max_err`); then one line per dtype of per-B=8-train-step sums (each
shape runs twice per tower).  `chip_smoke.py` times SDPA's backward at
the same shapes.  It uses only `PatchAttentionFunction.apply(qkv,
scale)`, autograd, `patch_attention_backward_reference` and the public
`patch_attention(..., lse=)` and `patch_attention_backward(q, k, v, o, g,
scale, out=, lse=)`, so copied into another checkout it times that
checkout's backward the same way (the A/B of PERF.md), whatever arguments
its kernels take.  Needs a CUDA device.

    python3 -m pcd_reg_hregnet_torch.time_attention --backward --dtypes bfloat16
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from .core.device import fp32_numerics
from .ops.kernels import attention as kattn

LEVELS = ((256, 64), (128, 128), (64, 256))   # (patch K, channels C)
HEADS = (2, 4, 8)


def shapes(B: int) -> list:
    """[R, H, K, d] of K3's launches in a forward of B pairs (each twice
    per tower: two PTv3 blocks per stage)."""
    return [(4 * B, H, K, C // H) for K, C in LEVELS for H in HEADS]


def device_ms(fn, reps: int, stream=None) -> float:
    """Device time of one `fn()` in ms: `reps` calls captured in a CUDA
    graph (on `stream` when given: a backward must be captured on the
    stream its forward ran on), replayed after a warm-up, timed with CUDA
    events."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def call_ms(fn, reps: int, stream=None) -> float:
    """Time of one `fn()` in ms as issued back to back from Python (on
    `stream` when given)."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
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


def host_ms(fn, reps: int, stream=None) -> float:
    """Host time of one `fn()` in ms: the median wall time of `reps` calls,
    each issued alone after a synchronize (so no queue of earlier work
    slows it)."""
    wall = []
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        fn()
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            fn()
            wall.append(time.perf_counter_ns() - t)
        torch.cuda.synchronize()
    return statistics.median(wall) * 1e-6


def backward_times(R: int, H: int, K: int, d: int, gen: torch.Generator, reps: int,
                   dtype: torch.dtype = torch.float32) -> dict:
    """Times of `PatchAttentionFunction`'s backward at [R, H, K, d] in
    `dtype`, and its gradient's error."""
    qkv = torch.randn((R, K, 3, H, d), generator=gen).to('cuda', dtype).requires_grad_()
    g = torch.randn((R, K, H, d), generator=gen).to('cuda', dtype)
    s = d ** -0.5
    side = torch.cuda.Stream()   # autograd runs the backward on the forward's stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = kattn.PatchAttentionFunction.apply(qkv, s)

    def bwd():
        return torch.autograd.grad(out, qkv, g, retain_graph=True)

    def both():
        return torch.autograd.grad(kattn.PatchAttentionFunction.apply(qkv, s), qkv, g)

    q, k, v = (t.detach() for t in kattn.unpack_qkv(qkv))
    ref = torch.stack(kattn.patch_attention_backward_reference(q, k, v, g.transpose(1, 2), s),
                      0).permute(1, 3, 0, 2, 4).float()   # [R, K, 3, H, d]
    (got,) = bwd()
    err = float((got.float() - ref).abs().max() / ref.abs().max())
    host = host_ms(bwd, 10 * reps, side)
    lse = torch.empty((R, H, K), device='cuda')
    o = kattn.patch_attention(q, k, v, s, lse=lse)
    dqkv = torch.empty_like(qkv)
    wrapper = host_ms(lambda: kattn.patch_attention_backward(
        q, k, v, o, g.transpose(1, 2), s, out=kattn.unpack_qkv(dqkv), lse=lse), 10 * reps)
    return {'ms': device_ms(bwd, reps, side), 'call_ms': call_ms(bwd, reps, side),
            'host_ms': host, 'wrapper_host_ms': wrapper,
            'fwd_bwd_ms': device_ms(both, reps), 'fwd_bwd_call_ms': call_ms(both, reps),
            'max_err': err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--backward', action='store_true',
                    help='time the backward (K3b) through PatchAttentionFunction')
    ap.add_argument('--dtypes', nargs='+', default=['float32', 'bfloat16'],
                    choices=['float32', 'bfloat16'], help='dtypes of --backward')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('time_attention needs a CUDA device')
    gen = torch.Generator().manual_seed(0)
    if args.backward:
        with fp32_numerics():
            for name in args.dtypes:
                dtype, step = getattr(torch, name), {}
                for B in (8, 1):
                    for R, H, K, d in shapes(B):
                        t = backward_times(R, H, K, d, gen, args.reps, dtype)
                        print(json.dumps({'B': B, 'K': K, 'd': d, 'H': H, 'dtype': name, **t}),
                              flush=True)
                        if B == 8:   # two PTv3 blocks per stage, two towers
                            for key, x in t.items():
                                if key != 'max_err':
                                    step[key] = step.get(key, 0.0) + 4 * x
                print(json.dumps({'per_B8_step': step, 'dtype': name}), flush=True)
        return 0
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
