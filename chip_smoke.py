#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`pcd_reg_hregnet_torch`) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line with seconds:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: one nvcc per source in `pcd_reg_hregnet_torch/csrc`, all at
   once, then one link; prints the build seconds and each kernel's
   registers, stack and spills;
3. kernels: each kernel against its plain PyTorch version on the card at
   every shape the serving forward gives it, with kernel, plain and
   library times.  FPS/WFPS: the wrapper's configuration table must be the
   compiled one; every compiled configuration that holds the row must give
   the plain version's indices on uniform, resample-padded (exact ties),
   grid-snapped and NaN-bearing rows at B=1 and B=8; each configuration is
   timed (the sweep behind the chooser), and the chosen one is timed with
   its latency floor, measured by the kernel's probe (the same steps with
   no distance update); rows of 2048-65536 points check and time the
   chooser's other bands; rows of 131072 and 1M points check and time the
   global-memory variant.  Patch attention within 1e-5 in f32 and 2e-2 in
   bf16: its tiling against the compiled one, every (K, d) of the forward
   at B=8 and B=1 timed beside SDPA, its bounds and a sweep of query rows
   per block (with a note where `plan`'s choice reads more than 5% slower
   than the sweep's best), then shapes with any K and d, and strided views;
   K3 and SDPA are timed as calls issued back to back (the JSON line's
   figures, as for FPS) and as device time (20 calls captured in a CUDA
   graph and replayed: `pcd_reg_hregnet_torch/time_attention.py`), which
   the bound's share is taken of;
4. serve: `model_v6` at full width (8096-point clouds, 1024/512/256
   keypoints, PTv3 depths (2,2,2)) with the trained flagship weights
   (`port_assets/r5_v11_knn_best_rre.npz`, the JAX package's `reg_v11`
   checkpoint) registers two raw synthetic test pairs through
   `serve.infer_pair`, a third with point-to-plane ICP (its `transform_icp`
   must be finite), and one B=8 batch through `serve.register`; every
   kernel's launch count must rise by exactly its launches per forward;
   outputs must be finite; the card's poses must agree with the port's CPU
   forward at B=1 within 1e-3 (R) and 1e-2 m (t), run on `CPU_THREADS`
   threads (its last bits, and so any near-tie it decides, depend on the
   count);
5. eval: `eval.runner.evaluate` of the same checkpoint over the synthetic
   test split at B=8 with point-to-plane ICP, on the pairs and ICP settings
   of `port_assets/v11_r5_eval_jax_cpu.json` (the JAX package's own eval of
   the checkpoint on the CPU); each kernel's launch count must rise by
   exactly its launches per forward times the batches; every pair's pose at
   each of the 4 layers (3 pyramid levels, ICP) is held against the JAX-CPU
   one: rotation entries within 1e-3 and translation within 1e-2 m, with at
   most `EVAL_MAX_OUTSIDE` pairs outside per layer (2 at the fine levels and
   ICP, 14 at the coarse level, where a weighted-FPS near-tie decided by the
   last bits of sigma flips ~12 pairs between any two correct
   implementations); each layer's `rre_deg` within
   0.005 deg, `rte_m` within 1e-3 m and `recall` within 2/256 of the JAX-CPU
   summary.  Prints the eval's seconds and pairs/s (host clock, indicative).

Ends with a JSON line of per-kernel numbers, the card's name and power
limit, the total seconds, and the result line.  In the JSON line, `ms`,
`plain_ms`, `bound_ms` and `library_ms` add up the kernel's calls in one
B=8 pair-forward (both towers); `launches` is the sum of the counts over
the main paths of phases 4 and 5, each counted from 0.  Exits non-zero, with no
result line, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bytes/s, f32 on
# the CUDA cores, bf16 on the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
BF16_FLOPS_S = 989e12
TF32_FLOPS_S = 495e12   # K3's f32 path runs 3 TF32 products per f32 product

N_POINTS = 8096
BATCH = 8
FPS_SHAPES = ((N_POINTS, 1024),)                 # K1: (N, M) per tower
WFPS_SHAPES = ((1024, 512), (512, 256))          # K2: L2, L3 per tower
FPS_KINDS = ('uniform', 'resampled', 'grid', 'nan')
TABLE_NS = (2048, 4096, 16384, 32768, 65536)     # the chooser's other bands
ATTN_DEPTH = 2                                   # PTv3 blocks per stage
TOWERS = 2
ATTN_TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
# [R, H, K, d] checked for correctness only: shapes the first K3 refused
# (K=1024 d=32, K=256 d=128, d=24, d=256 split over blocks, ragged K) and
# odd widths whose rows cannot be copied 16 bytes at a time
ATTN_OPENED = ((2, 2, 1024, 32), (4, 2, 256, 128), (4, 3, 64, 24), (2, 2, 64, 256),
               (4, 2, 100, 16), (2, 3, 100, 5), (1, 1, 1, 1), (2, 1, 33, 300))
GLOBAL_NS = (131072, 1 << 20)                    # FPS rows in device memory
# CPU vs card at B=1: an L2/L3 weighted-FPS near-tie may select another
# keypoint when sigmas differ in the last bits between the two devices
POSE_TOL_R = 1e-3
POSE_TOL_T = 1e-2   # metres
CPU_THREADS = 1     # the CPU forward's threads, as in tests/test_torch_*.py
SERVE_REPS = 20     # timed forwards per batch size
EVAL_REFERENCE = 'port_assets/v11_r5_eval_jax_cpu.json'
# Pairs of the 256 allowed outside the per-pair gate, per layer: layer_0
# is the coarse L3 pose, layer_1 and layer_2 the L2 and L1 poses, layer_3
# ICP.  A near-tie in weighted FPS, decided by sigma's last bits, picks
# another keypoint; on the coarse level's 256 keypoints that moves the pose
# past the gate on about 1 pair in 20 between any two correct f32
# implementations: against the same JAX-CPU file, the port's CPU forward
# puts 12 pairs outside there (and 2 at layer_1, 0 at layer_2;
# tools/compare_evals.py).  The coarse limit is those 12 plus the 2 the
# finer layers allow; a defect flips many more, and moves the summary.
EVAL_MAX_OUTSIDE = {'layer_0': 14, 'layer_1': 2, 'layer_2': 2, 'layer_3': 2}
EVAL_RRE_TOL = 0.005            # deg, each layer's summary
EVAL_RTE_TOL = 1e-3             # m
EVAL_RECALL_TOL = 2 / 256


def log(phase: str, t0: float, msg: str) -> None:
    print(f'[{phase} {time.perf_counter() - t0:7.2f}s] {msg}', flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of `fn` in ms over `reps` launches, after a warm-up."""
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


def nvidia_smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_summary(build_log: str) -> list[str]:
    """One line per kernel and report: entry name, then registers or spills."""
    out, entry = [], None
    for raw in build_log.splitlines():
        if 'ptxas info' not in raw:
            continue
        line = raw.split(':', 1)[1].strip()
        if line.startswith('Compiling entry function'):
            entry = line.split("'")[1]
        elif entry and ('spill' in line or line.startswith('Used')):
            out.append(f'{entry}: {line}')
    return out


def make_clouds(rng: np.random.Generator, n: int):
    """A raw target cloud and a decalibrated, noisy source cloud."""
    dst = rng.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)
    ang = np.deg2rad(rng.uniform(-10, 10, 3))
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    t = rng.uniform(-0.5, 0.5, 3)
    src = dst @ R.T + t + rng.normal(0.0, 0.02, dst.shape)
    return src.astype(np.float32), dst


def fps_rows(rng: np.random.Generator, kind: str, b: int, n: int) -> np.ndarray:
    """[b, n, 3] f32 rows of one kind: `uniform` in a 80 m cube; `resampled`,
    a raw cloud of 3000/8096 n points padded to n by `resample`'s
    duplication, as `serve.infer_pair` pads (exact distance ties);
    `grid`, uniform snapped to a 0.5 m grid (ties everywhere); `nan`,
    uniform with one NaN coordinate in row b // 2."""
    from pcd_reg_hregnet_torch.data.pipeline import resample
    xyz = rng.uniform(-40.0, 40.0, (b, n, 3)).astype(np.float32)
    if kind == 'resampled':
        raw = max(1, round(n * 3000 / N_POINTS))
        xyz = np.stack([resample(row[:raw], n, rng)[0] for row in xyz])
    elif kind == 'grid':
        xyz = np.round(xyz / 0.5) * np.float32(0.5)
    elif kind == 'nan':
        xyz[b // 2, n // 3, 1] = np.nan
    return np.ascontiguousarray(xyz, dtype=np.float32)


def fps_weights(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """Weights as the model builds them: 1/(sigma + 1e-5), mean-normalised
    per row, sigma = softplus(.) + 0.001."""
    sigma = np.log1p(np.exp(rng.normal(0.0, 2.0, (b, n)))) + 0.001
    w = 1.0 / (sigma + 1e-5)
    return (w / w.mean(axis=1, keepdims=True)).astype(np.float32)


def check_fps(torch, kfps, t0) -> list[dict]:
    """K1 at 8096 -> 1024 and K2 at 1024 -> 512 and 512 -> 256, B in {1, 8}:
    every compiled configuration that holds the row, on uniform, resampled,
    grid-snapped and NaN-bearing rows, must give the plain version's
    indices; then times of the chosen configuration (kernel, plain, bound,
    latency floor from the probe) and of every configuration (the sweep
    behind `ops/kernels/fps.py::BANDS`); then one 65536 -> 1024 row."""
    rng = np.random.default_rng(0)
    entries = []
    for name, shapes, weighted, wrapper, src in (
            ('fps', FPS_SHAPES, False, kfps.farthest_point_sample,
             'pcd_reg_hregnet_tpu/ops/pallas/fps.py:36'),
            ('weighted_fps', WFPS_SHAPES, True, kfps.weighted_farthest_point_sample,
             'pcd_reg_hregnet_tpu/ops/pallas/fps.py:36')):
        tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0}
        floor_fwd = 0.0
        by = {'bytes': 0.0, 'operations': 0.0}   # which term the bound sums
        for B in (1, BATCH):
            for n, m in shapes:
                chosen = kfps.choose_config(n)
                fits = [c for c in range(len(kfps.CONFIGS)) if kfps.capacity(c) >= n]
                w = (torch.from_numpy(fps_weights(rng, B, n)).cuda()
                     if weighted else None)
                for kind in FPS_KINDS:
                    xyz = torch.from_numpy(fps_rows(rng, kind, B, n)).cuda()
                    ref = kfps.fps_reference(xyz, w, m)
                    outs = {c: kfps._launch(xyz, w, m, c) for c in fits}
                    outs['wrapper'] = (wrapper(xyz, w, m) if weighted
                                       else wrapper(xyz, m))
                    torch.cuda.synchronize()
                    for c, got in outs.items():
                        if not torch.equal(got, ref):
                            bad = int((got != ref).sum())
                            raise AssertionError(
                                f'{name} B={B} {n}->{m} {kind} config {c}: {bad} '
                                f'indices differ from the plain version')
                log('kernels', t0, f'{name} B={B} N={n}->M={m}: indices identical to '
                    f'the plain version on {", ".join(FPS_KINDS)} rows in all '
                    f'{len(fits)} configurations that hold N')
                xyz = torch.from_numpy(fps_rows(rng, 'uniform', B, n)).cuda()
                sweep = {c: (cuda_ms(torch, lambda c=c: kfps._launch(xyz, w, m, c), 10),
                             cuda_ms(torch, lambda c=c: kfps.probe(xyz, m, c), 10))
                         for c in fits}
                for c, (ms_c, floor_c) in sweep.items():
                    log('kernels', t0, f'  sweep {name} B={B} N={n}: config {c} '
                        f'{kfps.CONFIGS[c]} (threads, points/thread, CTAs/row): '
                        f'{ms_c:.4f} ms ({ms_c / (m - 1) * 1e3:.3f} us/step), probe '
                        f'{floor_c:.4f} ms ({floor_c / (m - 1) * 1e3:.3f} us/step)'
                        f'{"  <- chosen" if c == chosen else ""}')
                call = ((lambda: wrapper(xyz, w, m)) if weighted
                        else (lambda: wrapper(xyz, m)))
                ms = cuda_ms(torch, call, 10)
                floor_ms = cuda_ms(torch, lambda: kfps.probe(xyz, m), 10)
                plain_ms = cuda_ms(torch, lambda: kfps.fps_reference(xyz, w, m), 1)
                nbytes = (B * n * 3 * 4 + (B * n * 4 if weighted else 0) + B * m * 4)
                flops = B * (m - 1) * n * (10 if weighted else 9)
                b_bytes, b_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
                log('kernels', t0, f'{name} B={B} N={n}->M={m}: config {chosen} '
                    f'{kfps.CONFIGS[chosen]}; kernel {ms:.4f} ms '
                    f'({ms / (m - 1) * 1e3:.3f} us/step), plain {plain_ms:.2f} ms, '
                    f'roofline bound {max(b_bytes, b_ops) * 1e3:.3f} us (bytes '
                    f'{b_bytes * 1e3:.3f} us, ops {b_ops * 1e3:.3f} us), latency floor '
                    f'{floor_ms:.4f} ms ({floor_ms / (m - 1) * 1e3:.3f} us/step, probe)')
                if B == BATCH:   # per-forward totals: one launch per tower
                    tot['ms'] += TOWERS * ms
                    tot['plain_ms'] += TOWERS * plain_ms
                    tot['bound_ms'] += TOWERS * max(b_bytes, b_ops)
                    floor_fwd += TOWERS * floor_ms
                    by['bytes' if b_bytes >= b_ops else 'operations'] += max(b_bytes, b_ops)
        log('kernels', t0, f'{name} per B={BATCH} forward: kernel {tot["ms"]:.3f} ms, '
            f'latency floor {floor_fwd:.3f} ms, roofline bound {tot["bound_ms"]:.5f} ms')
        entries.append({'name': name, 'route': 'cuda',
                        'source': 'pcd_reg_hregnet_torch/csrc/fps.cu',
                        'replaces': src, 'max_abs_err': 0,
                        'bound_by': max(by, key=by.get), 'library_ms': None, **tot})
    m = 1024   # the chooser's other bands, B=1: every configuration that holds N
    for n in TABLE_NS:
        xyz = torch.from_numpy(fps_rows(rng, 'resampled', 1, n)).cuda()
        ref = kfps.fps_reference(xyz, None, m)
        fits = [c for c in range(len(kfps.CONFIGS)) if kfps.capacity(c) >= n]
        for c in fits:
            if not torch.equal(kfps._launch(xyz, None, m, c), ref):
                raise AssertionError(f'fps {n}->{m} config {c}: indices differ '
                                     f'from the plain version')
            ms_c = cuda_ms(torch, lambda c=c: kfps._launch(xyz, None, m, c), 3)
            log('kernels', t0, f'  sweep fps B=1 N={n}->M={m}: config {c} '
                f'{kfps.CONFIGS[c]}: indices identical; {ms_c:.4f} ms '
                f'({ms_c / (m - 1) * 1e3:.3f} us/step)'
                f'{"  <- chosen" if c == kfps.choose_config(n) else ""}')
    n = kfps.BANDS[-1][0]
    xyz = torch.from_numpy(fps_rows(rng, 'resampled', 1, n)).cuda()
    w = torch.from_numpy(fps_weights(rng, 1, n)).cuda()
    if not torch.equal(kfps._launch(xyz, w, m), kfps.fps_reference(xyz, w, m)):
        raise AssertionError(f'weighted fps {n}->{m}: indices differ from the plain '
                             f'version')
    log('kernels', t0, f'weighted_fps B=1 N={n}->M={m}: indices identical')
    for n in GLOBAL_NS:   # above the bands: the global-memory variant
        for weighted, kind in ((False, 'grid'), (True, 'uniform')):
            xyz = torch.from_numpy(fps_rows(rng, kind, 1, n)).cuda()
            w = torch.from_numpy(fps_weights(rng, 1, n)).cuda() if weighted else None
            if kfps.choose_config(n) != kfps.GLOBAL_MEMORY:
                raise AssertionError(f'fps N={n} does not take the global-memory variant')
            got = kfps._launch(xyz, w, m)
            if not torch.equal(got, kfps.fps_reference(xyz, w, m)):
                raise AssertionError(f'{"weighted " if weighted else ""}fps {n}->{m} '
                                     f'global-memory variant: indices differ from '
                                     f'the plain version')
            ms = cuda_ms(torch, lambda: kfps._launch(xyz, w, m), 2)
            log('kernels', t0, f'{"weighted_fps" if weighted else "fps"} B=1 N={n}->M={m} '
                f'({kind} row), global-memory variant: indices identical; {ms:.3f} ms '
                f'({ms / (m - 1) * 1e3:.2f} us/step)')
    return entries


def check_fps_table(lib, kfps) -> None:
    """The wrapper's configuration table must be the compiled one."""
    import ctypes
    t, p, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    compiled = []
    while lib.lib.pcdreg_fps_config(len(compiled), t, p, c) > 0:
        compiled.append((t.value, p.value, c.value))
    if tuple(compiled) != kfps.CONFIGS:
        raise AssertionError(f'csrc/fps.cu configurations {compiled} differ from '
                             f'ops/kernels/fps.py CONFIGS {kfps.CONFIGS}')


def attn_bounds(R, H, K, d, dtype, esize):
    """(bytes, operations) times in ms of one call: each input read once and
    the output written once over HBM; FLOPs over the card's rate for the
    products the kernel runs (f32: three TF32 products each; also returned,
    third, against the 67 TFLOP/s of f32 on the CUDA cores)."""
    nbytes = 4 * R * H * K * d * esize
    flops = 4 * R * H * K * K * d
    rate = TF32_FLOPS_S / 3 if esize == 4 else BF16_FLOPS_S
    return nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3, flops / F32_FLOPS_S * 1e3


def block_shapes(d, dtype):
    """Every (rows per block, warps per 16 rows) the kernel is built with
    for head dim d."""
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    shapes = []
    for split in kattn.splits(d, dtype):
        for bm in kattn.BLOCK_ROWS:
            try:
                kattn.plan(1, 1, 64, d, dtype, bm, split)
            except ValueError:   # more warps or shared memory than a block has
                continue
            shapes.append((bm, split))
    return shapes


def check_attention(torch, lib, kattn, gen, t0) -> dict:
    """K3: its tiling against the compiled one; every (K, d) of the forward
    at B=8 and B=1 (R = 4B), f32 and bf16, against the plain version, timed
    beside SDPA and its bounds, with the sweep of query rows per block; the
    shapes the first K3 refused, and strided views, for correctness."""
    import ctypes

    from pcd_reg_hregnet_torch.time_attention import call_ms, device_ms, shapes
    F = torch.nn.functional
    dp, bn, sl = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 5, 8, 9, 16, 24, 32, 48, 64, 100, 128, 129, 256, 300):
            for bm, split in block_shapes(d, dtype):
                p = kattn.plan(1, 1, 64, d, dtype, bm, split)
                smem = lib.lib.pcdreg_attention_plan(d, kattn._DTYPE_CODES[dtype], bm, split,
                                                     dp, bn, sl)
                if (smem, dp.value, bn.value, sl.value) != (p.smem, p.dp, p.bn, p.slices):
                    raise AssertionError(f'attention plan d={d} {dtype}: csrc ({smem}, '
                                         f'{dp.value}, {bn.value}, {sl.value}) != '
                                         f'ops/kernels {p}')

    def check(q, k, v, scale, out=None, what='', shape=(None, None)):
        got = kattn._launch(q, k, v, scale, out, *shape)
        ref = kattn.patch_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = ATTN_TOL[str(q.dtype).split('.')[-1]]
        if not err <= tol:
            raise AssertionError(f'patch_attention {what} {tuple(q.shape)} {q.dtype}: '
                                 f'max |err| {err} > {tol}')
        return err

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0}
    dev_fwd = lib_dev_fwd = bound_67 = 0.0
    max_err = 0.0
    by = {'bytes': 0.0, 'operations': 0.0}
    for B in (BATCH, 1):
        for R, H, K, d in shapes(B):
            scale = d ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn((R, H, K, d), generator=gen).to('cuda', dtype)
                           for _ in range(3))
                err = check(q, k, v, scale)
                ms = call_ms(lambda: kattn.patch_attention(q, k, v, scale), 20)
                dev = device_ms(lambda: kattn.patch_attention(q, k, v, scale), 20)
                plain_ms = call_ms(lambda: kattn.patch_attention_reference(
                    q, k, v, scale), 20)
                lib_ms = call_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 20)
                lib_dev = device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale), 20)
                b_bytes, b_ops, b_67 = attn_bounds(R, H, K, d, dtype, q.element_size())
                p = kattn.plan(R, H, K, d, dtype, sms=sms)
                bound = max(b_bytes, b_ops)
                kind = 'bytes' if b_bytes >= b_ops else 'operations'
                extra = (f', bound at 67 TFLOP/s {max(b_bytes, b_67) * 1e3:.2f} us'
                         if dtype == torch.float32 else '')
                log('kernels', t0, f'patch_attention B={B} R={R} H={H} K={K} d={d} '
                    f'{str(dtype)[6:]}: max|err| {err:.2e}; back to back: kernel '
                    f'{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, sdpa '
                    f'{lib_ms * 1e3:.2f} us; device time: kernel {dev * 1e3:.2f} us '
                    f'(bm {p.bm}, split {p.split}), sdpa {lib_dev * 1e3:.2f} us '
                    f'({lib_dev / dev:.2f}x the kernel), bound {bound * 1e3:.2f} us '
                    f'({kind}){extra}, share of bound {bound / dev:.1%}')
                sweep = {}
                for c in block_shapes(d, dtype):
                    err = max(err, check(q, k, v, scale, what=f'(bm, split) {c}', shape=c))
                    sweep[c] = device_ms(lambda c=c: kattn._launch(
                        q, k, v, scale, bm=c[0], split=c[1]), 20)
                log('kernels', t0, '  sweep (bm, split), device time: ' + ', '.join(
                    f'{c} {t * 1e3:.2f} us' for c, t in sweep.items()))
                best = min(sweep, key=sweep.get)
                if sweep[(p.bm, p.split)] > 1.05 * sweep[best]:
                    log('kernels', t0, f'  note: plan\'s {(p.bm, p.split)} reads '
                        f'{sweep[(p.bm, p.split)] / sweep[best] - 1:.0%} slower than {best}')
                if dtype == torch.float32 and B == BATCH:   # the forward runs f32
                    n = ATTN_DEPTH * TOWERS
                    tot['ms'] += n * ms
                    tot['plain_ms'] += n * plain_ms
                    tot['library_ms'] += n * lib_ms
                    tot['bound_ms'] += n * bound
                    dev_fwd += n * dev
                    lib_dev_fwd += n * lib_dev
                    bound_67 += n * max(b_bytes, b_67)
                    max_err = max(max_err, err)
                    by[kind] += bound
    log('kernels', t0, f'patch_attention per B={BATCH} forward (f32): back to back: '
        f'kernel {tot["ms"]:.4f} ms, sdpa {tot["library_ms"]:.4f} ms, plain '
        f'{tot["plain_ms"]:.4f} ms; device time: kernel {dev_fwd:.4f} ms, sdpa '
        f'{lib_dev_fwd:.4f} ms; bound {tot["bound_ms"]:.4f} ms (3xTF32), '
        f'{bound_67:.4f} ms (67 TFLOP/s)')

    for shape in ATTN_OPENED:   # correctness only
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen).to('cuda', dtype) for _ in range(3))
            err = max(check(q, k, v, shape[-1] ** -0.5, what=f'(bm, split) {c}', shape=c)
                      for c in [(None, None)] + block_shapes(shape[-1], dtype))
            log('kernels', t0, f'patch_attention {shape} {str(dtype)[6:]}: max|err| {err:.2e} '
                f'over every (rows per block, split)')
    for R, H, K, d in ((4 * BATCH, 2, 256, 32), (4, 8, 64, 32), (2, 3, 100, 24)):
        for dtype in (torch.float32, torch.bfloat16):   # the model's views
            qkv = torch.randn((R, K, 3, H, d), generator=gen).to('cuda', dtype)
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
            buf = torch.empty((R, K, H, d), dtype=dtype, device='cuda')
            err = check(q, k, v, d ** -0.5, buf.transpose(1, 2), 'strided')
            log('kernels', t0, f'patch_attention strided views of [R, K, 3, H, d] = '
                f'{(R, K, 3, H, d)} into [R, K, H, d] {str(dtype)[6:]}: max|err| {err:.2e}')
    return {'name': 'patch_attention', 'route': 'cuda',
            'source': 'pcd_reg_hregnet_torch/csrc/attention.cu',
            'replaces': 'pcd_reg_hregnet_tpu/ops/pallas/attention.py:31',
            'max_abs_err': max_err, 'bound_by': max(by, key=by.get), **tot}


def per_forward_launches(cfg) -> dict:
    """Each kernel's launches in one pair-forward (both towers)."""
    return {'fps': TOWERS,
            'weighted_fps': TOWERS * (len(cfg.levels) - 1),
            'patch_attention': TOWERS * len(cfg.levels) * sum(cfg.ptv3_depths)}


def kernel_wrappers() -> dict:
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.ops.kernels import fps as kfps
    return {'fps': kfps.farthest_point_sample,
            'weighted_fps': kfps.weighted_farthest_point_sample,
            'patch_attention': kattn.patch_attention}


def check_launches(launches: dict, per_forward: dict, forwards: int) -> None:
    for k, n in per_forward.items():
        if launches[k] != n * forwards:
            raise AssertionError(f'{k}: {launches[k]} launches over {forwards} '
                                 f'forwards, expected {n} per forward')


def synthetic_pairs(n: int):
    """The first `n` raw synthetic test pairs, decalibrated by the test
    split's twist table: (source, target) clouds of 16192 points."""
    from pcd_reg_hregnet_torch.data.pipeline import apply_decalibration, read_perturbation_table
    from pcd_reg_hregnet_torch.data.synthetic import SyntheticPairSource
    from pcd_reg_hregnet_torch.core.config import ASSETS_DIR
    source = SyntheticPairSource(length=256, points_per_cloud=2 * N_POINTS, seed=202)
    table = read_perturbation_table(str(ASSETS_DIR / 'perturbations_synthetic_test.txt'), n)
    pairs = []
    for i in range(n):
        raw = source.load_pair(i)
        pairs.append((apply_decalibration(raw['pcd_right'], table[i])[0], raw['pcd_left']))
    return pairs


def serve_phase(torch, t0) -> dict:
    from pcd_reg_hregnet_torch import serve
    from pcd_reg_hregnet_torch.data.pipeline import range_filter, resample
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.ops.sampling import fps
    from pcd_reg_hregnet_torch.utils.checkpoint import FLAGSHIP

    model = zoo.build('model_v6', device='cuda', weights=FLAGSHIP)
    cfg = model.cfg
    per_forward = per_forward_launches(cfg)
    wrappers = kernel_wrappers()
    log('serve', t0, f'model_v6 built on the card with the trained weights of {FLAGSHIP.name}: '
        f'{sum(p.numel() for p in model.parameters())} parameters, levels '
        f'{[lvl.nsample for lvl in cfg.levels]}, depths {cfg.ptv3_depths}')
    raw_pairs = synthetic_pairs(3)
    rng = np.random.default_rng(7)
    batch = [make_clouds(rng, N_POINTS) for _ in range(BATCH)]
    src8 = np.stack([s for s, _ in batch])
    dst8 = np.stack([d for _, d in batch])

    # --- the main path, counted -------------------------------------------
    for w in wrappers.values():
        w.launches = 0
    t_main = time.perf_counter()
    poses = [serve.infer_pair(model, s, d, device='cuda') for s, d in raw_pairs[:2]]
    pose_icp = serve.infer_pair(model, *raw_pairs[2], device='cuda', icp='point_to_plane')
    out8 = serve.register(model, src8, dst8, device='cuda')
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = len(raw_pairs) + 1
    log('serve', t0, f'{len(raw_pairs)} infer_pair (one with point-to-plane ICP) + 1 '
        f'register(B={BATCH}) in {main_s:.2f} s; launches {launches}')
    check_launches(launches, per_forward, forwards)
    for p in poses + [pose_icp]:
        if not np.all(np.isfinite(np.asarray(p['transform']))):
            raise AssertionError(f'non-finite pose from infer_pair: {p}')
    T_icp = np.asarray(pose_icp['transform_icp'])
    if T_icp.shape != (4, 4) or not np.all(np.isfinite(T_icp)):
        raise AssertionError(f'infer_pair(icp=point_to_plane): transform_icp {T_icp}')
    log('serve', t0, f'infer_pair with ICP: transform_icp finite, '
        f'{"refined" if np.abs(T_icp - np.asarray(pose_icp["transform"])).max() > 0 else "kept"}'
        f' by the trust gate')
    R8, t8 = out8['rotation'], out8['translation']
    if tuple(R8.shape) != (BATCH, 3, 3) or tuple(t8.shape) != (BATCH, 3):
        raise AssertionError(f'register shapes {tuple(R8.shape)} {tuple(t8.shape)}')
    if not (torch.isfinite(R8).all() and torch.isfinite(t8).all()):
        raise AssertionError('non-finite pose from register')
    log('serve', t0, f'poses finite; per forward +{per_forward["fps"]} fps, '
        f'+{per_forward["weighted_fps"]} weighted_fps, '
        f'+{per_forward["patch_attention"]} patch_attention')

    # --- throughput ---------------------------------------------------------
    def timed(src, dst, reps):
        """min, median and max ms of `reps` forwards, each ending in a sync."""
        serve.register(model, src, dst, device='cuda')
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            serve.register(model, src, dst, device='cuda')
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return min(times), float(np.median(times)), max(times)

    src8_d = torch.from_numpy(src8).cuda()
    dst8_d = torch.from_numpy(dst8).cuda()
    for b, (src, dst) in ((BATCH, (src8_d, dst8_d)),
                          (1, (src8_d[:1].contiguous(), dst8_d[:1].contiguous()))):
        lo, med, hi = timed(src, dst, SERVE_REPS)
        log('serve', t0, f'forward B={b}: median {med:.1f} ms ({b / med * 1e3:.1f} pairs/s), '
            f'min {lo:.1f}, max {hi:.1f} over {SERVE_REPS} forwards after one warm-up '
            f'(host clock; indicative only)')

    # --- the card against the port's CPU forward, B=1 ----------------------
    prep = []
    rng_p = np.random.default_rng(0)
    for pts in raw_pairs[0]:
        pts, _ = range_filter(pts, 80.0)
        pts, _ = resample(pts, N_POINTS, rng_p)
        prep.append(pts[None])
    cpu_model = zoo.build('model_v6', device='cpu', weights=FLAGSHIP)
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        t_cpu = time.perf_counter()
        with torch.no_grad():
            out_cpu = cpu_model(torch.from_numpy(prep[0]), torch.from_numpy(prep[1]))
        cpu_s = time.perf_counter() - t_cpu
        idx_cpu = fps(torch.from_numpy(prep[0]), cfg.levels[0].nsample)
    finally:
        torch.set_num_threads(threads)
    with torch.no_grad():
        out_gpu = model(torch.from_numpy(prep[0]).cuda(), torch.from_numpy(prep[1]).cuda())
    idx_gpu = fps(torch.from_numpy(prep[0]).cuda(), cfg.levels[0].nsample).cpu()
    if not torch.equal(idx_gpu, idx_cpu):
        raise AssertionError('L1 FPS indices differ between the card and the CPU')

    def dxyz(lvl):
        return max(float((out_gpu[s][f'xyz_{lvl}'].cpu() - out_cpu[s][f'xyz_{lvl}']).abs().max())
                   for s in ('src_feats', 'dst_feats'))
    log('serve', t0, 'keypoints card vs CPU, max|dxyz| (m; a keypoint chosen differently '
        'shows at its level and the coarser ones): '
        + ', '.join(f'L{lvl} {dxyz(lvl):.2e}' for lvl in (1, 2, 3)))
    worst_r = worst_t = 0.0
    for lvl, (Rg, tg, Rc, tc) in enumerate(zip(out_gpu['rotation'], out_gpu['translation'],
                                               out_cpu['rotation'], out_cpu['translation'])):
        dr = float((Rg.cpu() - Rc).abs().max())
        dt = float((tg.cpu() - tc).abs().max())
        worst_r, worst_t = max(worst_r, dr), max(worst_t, dt)
        log('serve', t0, f'level {3 - lvl}: card vs CPU max|dR| {dr:.2e}, max|dt| {dt:.2e} m')
    if not (worst_r <= POSE_TOL_R and worst_t <= POSE_TOL_T):
        raise AssertionError(f'card vs CPU poses: |dR| {worst_r} (tol {POSE_TOL_R}), '
                             f'|dt| {worst_t} (tol {POSE_TOL_T})')
    log('serve', t0, f'L1 FPS indices identical card vs CPU; poses within '
        f'{POSE_TOL_R} / {POSE_TOL_T} m (CPU forward {cpu_s:.1f} s on {CPU_THREADS} '
        f'threads)')
    return launches


def eval_breakdown(torch, t0, cfg, meta, batches: int) -> None:
    """Where the eval's time goes, per B=8 batch: host generation of the
    pairs (a fresh source, so no pair comes from its cache), the network
    forward and ICP (CUDA events; indicative)."""
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.eval.icp import refine
    from pcd_reg_hregnet_torch.eval.runner import load_model
    from pcd_reg_hregnet_torch.geometry import se3
    from pcd_reg_hregnet_torch.utils.checkpoint import FLAGSHIP

    ds = load_dataset(cfg.data, 'test', length=cfg.data.batch_size)
    t = time.perf_counter()
    batch = next(batch_iterator(ds, cfg.data.batch_size))
    data_s = time.perf_counter() - t
    model = load_model(cfg, FLAGSHIP, 'cuda')
    src = torch.from_numpy(batch['uncalibed_pcd']).cuda()
    dst = torch.from_numpy(batch['pcd_left']).cuda()
    with torch.no_grad():
        out = model(src, dst)
    pose = se3.pack(out['rotation'][-1], out['translation'][-1])
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: model(src, dst), 3)
    icp_ms = cuda_ms(torch, lambda: refine(src, dst, pose, meta['icp'], meta['icp_threshold'],
                                           meta['icp_iters']), 3)
    log('eval', t0, f'per B={cfg.data.batch_size} batch (indicative): pair generation on the '
        f'host {data_s * 1e3:.0f} ms, forward {fwd_ms:.1f} ms, {meta["icp"]} ICP '
        f'{icp_ms:.1f} ms (CUDA events); x {batches} batches: {data_s * batches:.1f} s, '
        f'{fwd_ms * batches / 1e3:.1f} s, {icp_ms * batches / 1e3:.1f} s')


def eval_phase(torch, t0, smi: str) -> dict:
    """The test split through `eval.runner.evaluate` on the card, held pair
    for pair and layer for layer against the JAX package's CPU eval."""
    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.eval.calib_eval import pose_deviation
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    from pcd_reg_hregnet_torch.utils import checkpoint

    with open(EVAL_REFERENCE) as f:
        ref = json.load(f)
    meta = ref['reference']
    cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
    if meta['batch_size'] != cfg.data.batch_size or meta['split'] != 'test':
        raise AssertionError(f'{EVAL_REFERENCE} was made at {meta}, the checkpoint '
                             f'evaluates the test split at B={cfg.data.batch_size}')
    pairs = meta['pairs']
    ds = load_dataset(cfg.data, 'test', length=pairs)
    per_forward = per_forward_launches(cfg.model)
    wrappers = kernel_wrappers()

    # --- the main path, counted -------------------------------------------
    for w in wrappers.values():
        w.launches = 0
    t_main = time.perf_counter()
    out = evaluate(cfg, checkpoint.FLAGSHIP, split='test', icp=meta['icp'],
                   icp_threshold=meta['icp_threshold'], icp_iters=meta['icp_iters'],
                   dataset=ds, device='cuda')
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_main
    launches = {k: w.launches for k, w in wrappers.items()}
    forwards = -(-pairs // cfg.data.batch_size)
    log('eval', t0, f'evaluate(test, B={cfg.data.batch_size}, icp={meta["icp"]}, '
        f'{meta["icp_iters"]} iterations): {pairs} pairs in {eval_s:.2f} s '
        f'({pairs / eval_s:.1f} pairs/s, host clock, data generation included; '
        f'indicative only) on {smi}; launches {launches}')
    check_launches(launches, per_forward, forwards)
    eval_breakdown(torch, t0, cfg, meta, forwards)

    deviation = pose_deviation(out, ref)
    layers = sorted(k for k in ref if k.startswith('layer_'))
    if sorted(deviation) != layers or sorted(k for k in out if k.startswith('layer_')) != layers:
        raise AssertionError(f'layers {sorted(out)} differ from the reference {layers}')
    outside = np.zeros(pairs, bool)
    worst = (0.0, None, None, '')
    failed = []
    for name in layers:
        got, want = out[name], ref[name]
        dR, dt = deviation[name]
        bad = (dR > POSE_TOL_R) | (dt > POSE_TOL_T)
        outside |= bad
        i = int(np.argmax(np.maximum(dR / POSE_TOL_R, dt / POSE_TOL_T)))
        score = max(dR[i] / POSE_TOL_R, dt[i] / POSE_TOL_T)
        if score > worst[0]:
            worst = (score, i, name, f'|dR| {dR[i]:.2e}, |dt| {dt[i]:.2e} m')
        rre = (np.mean(got['rre']), np.mean(want['rre']))
        rte = (np.mean(got['rte']), np.mean(want['rte']))
        rec = (got['recall'], want['recall'])
        log('eval', t0, f'{name}: card rre_deg {rre[0]:.5f} rte_m {rte[0]:.5f} recall '
            f'{rec[0]:.4f}; JAX CPU {rre[1]:.5f} {rte[1]:.5f} {rec[1]:.4f}; '
            f'{int(bad.sum())} pairs outside the per-pair gate (at most '
            f'{EVAL_MAX_OUTSIDE[name]}) {np.flatnonzero(bad).tolist()}; max |dR| {dR.max():.2e}, '
            f'max |dt| {dt.max():.2e} m, median |dR| {np.median(dR):.2e}')
        if bad.sum() > EVAL_MAX_OUTSIDE[name]:
            failed.append(f'{name}: {int(bad.sum())} pairs outside the per-pair gate, at most '
                          f'{EVAL_MAX_OUTSIDE[name]}: {np.flatnonzero(bad).tolist()}')
        if not (abs(rre[0] - rre[1]) <= EVAL_RRE_TOL and abs(rte[0] - rte[1]) <= EVAL_RTE_TOL
                and abs(rec[0] - rec[1]) <= EVAL_RECALL_TOL):
            failed.append(f'{name} summary: card rre {rre[0]}, rte {rte[0]}, recall {rec[0]}; '
                          f'JAX CPU {rre[1]}, {rte[1]}, {rec[1]}')
    log('eval', t0, f'{int(outside.sum())} of {pairs} pairs outside the per-pair gate '
        f'(R {POSE_TOL_R}, t {POSE_TOL_T} m) at some layer; worst: pair {worst[1]} '
        f'{worst[2]} {worst[3]}')
    if failed:
        raise AssertionError('; '.join(failed))
    for key in ('summary', 'summary_network'):
        log('eval', t0, f'{key}: card ' + ', '.join(
            f'{k} {out[key][k]:.5f}' for k in ('rre_deg', 'rte_m', 'rre_p95', 'rte_p95'))
            + '; JAX CPU ' + ', '.join(
            f'{k} {ref[key][k]:.5f}' for k in ('rre_deg', 'rte_m', 'rre_p95', 'rte_p95')))
    return launches


def main() -> int:
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; nothing to check',
              file=sys.stderr)
        return 1
    from pcd_reg_hregnet_torch.core.device import fp32_numerics
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.ops.kernels import build as kbuild
    from pcd_reg_hregnet_torch.ops.kernels import fps as kfps

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log('device', t0, f'{kind}; nvidia-smi: {smi}; torch {torch.__version__} '
        f'cuda {torch.version.cuda}; count {torch.cuda.device_count()}')

    lib = kbuild.library()
    log('build', t0, f'build_s {lib.build_s:.1f} ({len(kbuild.sources())} sources '
        f'compiled in parallel, then linked)')
    for line in ptxas_summary(lib.build_log):
        print(f'  ptxas {line}')

    check_fps_table(lib, kfps)
    gen = torch.Generator().manual_seed(0)
    with fp32_numerics():   # the plain versions in full f32, as in the model's forward
        entries = check_fps(torch, kfps, t0)
        entries.append(check_attention(torch, lib, kattn, gen, t0))

    launches = serve_phase(torch, t0)
    eval_launches = eval_phase(torch, t0, smi)
    for e in entries:
        e['launches'] = launches[e['name']] + eval_launches[e['name']]
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    print(json.dumps({'kernels': [{k: e[k] for k in keys} for e in entries]}))
    print(nvidia_smi())
    print(f'total_s {time.perf_counter() - t0:.1f}')
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
