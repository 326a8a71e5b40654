"""Tracing and timing (port of `pcd_reg_hregnet_tpu/utils/profiling.py`).

* `trace(log_dir)`: `torch.profiler` around a block (host and, with a card,
  CUDA activity); writes a Chrome/Perfetto trace to `log_dir`;
* `StepTimer`: wall-clock step timing that waits for the card before it
  reads the clock (CUDA runs asynchronously), with percentiles;
* `time_fn`: mean seconds per call after warm-up calls.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; the trace goes to `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _sync(outputs=None) -> None:
    """Wait for the current CUDA device, once CUDA is initialised, and for
    every other CUDA device that holds a tensor of `outputs` (nested dicts,
    lists and tuples)."""
    if not torch.cuda.is_initialized():
        return
    devices = {torch.device('cuda', torch.cuda.current_device())}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(outputs)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock step timing with an explicit device barrier: `step()`
    waits for the current CUDA device (and the devices of `outputs`, where
    given) before it stops the clock, so it measures the compute, not the
    launch, also when the block makes its outputs itself."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def step(self, outputs=None):
        t0 = time.perf_counter()
        yield
        _sync(outputs)
        self.samples.append(time.perf_counter() - t0)

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        s = np.asarray(self.samples[skip_first:] or self.samples)
        return {
            'mean_ms': float(s.mean() * 1000),
            'p50_ms': float(np.percentile(s, 50) * 1000),
            'p95_ms': float(np.percentile(s, 95) * 1000),
            'steps_per_sec': float(1.0 / s.mean()),
            'n': int(len(s)),
        }


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean seconds per call over `iters` calls, after `warmup` calls, with a
    device barrier after each phase."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters
