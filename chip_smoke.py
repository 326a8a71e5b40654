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
   than the sweep's best), then phase 18's five shapes at B=8 in f32 (with
   their per-forward total), shapes with any K and d, and strided views;
   K3 and SDPA are timed as calls issued back to back (the JSON line's
   figures, as for FPS) and as device time (20 calls captured in a CUDA
   graph and replayed: `pcd_reg_hregnet_torch/time_attention.py`), which
   the bound's share is taken of.  The attention backward (K3b): its block
   tilings and `plan_backward` against the compiled ones; against its
   plain version within `ATTN_BWD_TOL` of each gradient's largest value, in
   every tiling, at every (K, d) of the train step at B=8 and B=1, phase
   18's five shapes at B=8 (f32) and every `ATTN_OPENED` shape, on strided
   views, two calls bit-identical, with
   K3's log-sum-exp (which K3b takes) within `ATTN_LSE_TOL` of the plain
   one; timed back to back and as device time beside its bounds (3xTF32 and
   f32 CUDA cores) and SDPA's backward, with the sweep of tilings behind
   `plan_backward` (a note where its choice reads more than 5% slower than
   the sweep's best).  Then K3b in bf16 the same way (the plain backward's
   f32 result cast to bf16, within `ATTN_BWD_TOL_BF16` of each gradient's
   largest value; K3's log-sum-exp from bf16 inputs within
   `ATTN_LSE_TOL`), beside SDPA's bf16 backward and its bound on the bf16
   tensor cores: each shape on the route `plan_backward` names for it
   (`csrc/attention_bwd_bf16.cu` on wgmma for every shape of the train
   step, the bf16 mma.sync instantiations of `csrc/attention_bwd.cu` for
   the rest), the route's plan against the compiled one, every tiling of
   the route, and the `ATTN_OPENED_WGMMA` shapes as well, each held to the
   wgmma route.  K3 and K3b each have an f32 and a bf16 row in
   the JSON line;
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
   summary.  Prints the eval's seconds and pairs/s (host clock, indicative);
6. train: `train.loop.fit` of `reg_v11` from the trained flagship at full
   width (B=8 x 8096 points, the flagship's OneCycle schedule) on the
   synthetic train split for `TRAIN_STEPS` steps, with a short validation
   and its checkpoints: launches exactly K1 2, K2 4, K3 36 and K3b 36 per
   step (plus the validation's forwards), loss and gradient norm finite at
   every step; then, with `train.loop.make_train_step`: the launches of
   single steps, TF32 off in the backward (read by a gradient hook with the
   process default set to True), the median synced step time, peak memory
   and device ops per step (torch.profiler); one step with the kernels
   against one with the plain versions of all four on the same batch and
   weights (keypoints identical at every level, else the next batch; loss
   within `TRAIN_LOSS_TOL`, each gradient within `TRAIN_GRAD_TOL` of the
   global norm); and a checkpoint round trip whose next step equals the
   step without it;
7. bf16_serve: phase 4 for the flagship in bf16 (`compute_dtype='bfloat16'`
   over the checkpoint's config, as `--compute-dtype` serves it):
   launches exactly K1 2, K2 4 and K3 36 per forward, K3 counted in bf16;
   poses finite and f32; the card's B=1 poses against the port's CPU bf16
   forward within `BF16_POSE_TOL`; the B=1 and B=8 medians beside phase
   4's;
8. bf16_eval: phase 5 in bf16 against `BF16_EVAL_REFERENCE` (the JAX
   package's CPU eval of the flagship in bf16), limits
   `BF16_EVAL_MAX_OUTSIDE`, `BF16_EVAL_SUMMARY_TOL` and the bf16-sized
   per-pair gate `BF16_EVAL_PAIR_GATE`; the card's bf16
   summary printed beside its f32 one (the accuracy cost of serving in
   bf16, no gate);
9. bf16_train: phase 6 for `reg_v11` in bf16 from the flagship: launches
   exactly 2/4/36/36 per step with K3 and K3b in bf16, every step finite,
   the kernels-vs-plain step within `BF16_TRAIN_TOL`, median step ms, peak
   memory and device ops beside phase 6's, and a checkpoint resumed as the
   train command takes it without `--compute-dtype` (still bf16, the next
   step equal);
10. a1_serve: phase 4 for the trained A1 checkpoint, `model_v2` (conv
   descriptors, FineReg2 MI outputs) with the weights of
   `port_assets/r4_v6_50_best_rre.npz` (the JAX package's `reg_v6`):
   launches exactly K1 2, K2 4, K3 0, K3b 0 per forward;
11. a1_eval: phase 5 for the same checkpoint, against
   `port_assets/v6_r4_eval_jax_cpu.json`, with at most
   `A1_EVAL_MAX_OUTSIDE` pairs outside the per-pair gate per layer;
12. a1_train: phase 6 for `reg_v6` (Tf + chamfer + MI, AdamW, OneCycle,
   clip 1.0) from the same checkpoint, the MI discriminators included: the
   tf, chamfer and MI terms finite at every step, and the checkpoint round
   trip carrying the discriminators and their optimizer state;
13. presets: every other registration experiment (`PRESETS`) with seeded
   weights at full width: one B=8 forward through `serve.register` and one
   train step each, launches exactly as the preset implies (K3 and K3b
   only on `model_v6`, K3b only for the levels an optimised loss reaches),
   poses, loss terms (under their JAX names) and gradient norm finite;
14. feats_detector, feats_descriptor: `train.feats_loop.fit_feats` at full
   width on the synthetic train split, `FEATS_STEPS` steps per stage: the
   detector stage at B=16 from the weights of
   `port_assets/r5_feats_desc_feats_descriptor.npz` (the JAX package's
   trained descriptor stage), then the descriptor stage at B=8 from the
   detector stage's checkpoint; launches exactly K1 2, K2 4, K3 36 and K3b
   0 (detector: no loss reads the descriptors) or 36 (descriptor) per
   step, every loss term finite, every detector parameter bit-identical
   through the descriptor stage; then each stage's single steps as in
   phase 6 (launches, TF32, time, memory, device ops, kernels against plain
   versions, checkpoint round trip), and the detector stage's unread PTv3
   forward timed;
15. feats_losses: the descriptor checkpoint's objective at eval on the 16
   test pairs of `port_assets/feats_desc_r5_feats_jax_cpu.json` (the JAX
   package's CPU values): each pair's per-level chamfer and matching losses
   within `FEATS_ANY_RTOL` relative, and within `FEATS_PAIR_RTOL` but for
   at most `FEATS_MAX_OUTSIDE` of the pairs that take JAX's level-3
   keypoints; the plain versions on the card pick the same keypoints and
   give every loss within `TRAIN_LOSS_TOL`;
16. warm_eval: phase 5 for the warm-started `reg_v11` checkpoint
   (`port_assets/r4_v11_warm_best_rre.npz`) against
   `port_assets/v11_warm_r4_eval_jax_cpu.json`, limits
   `WARM_EVAL_MAX_OUTSIDE` and `WARM_EVAL_SUMMARY_TOL`;
17. warm_start: `train.loop.fit` of `reg_v11` with `pretrain_feats` = the
   descriptor export: before step 1 every `feature_extraction` entry is the
   checkpoint's and every other the seeded init; `WARM_STEPS` steps and a
   short validation, launches exactly 2/4/36/36 per step, all finite;
18. ptv3_full: the full PointTransformerV3 (`PTV3_FULL`: the JAX module's
   defaults, encoder-decoder, blocks alternating z and Hilbert orders,
   serialized pooling) with seeded weights on B=8 synthetic test scenes of
   `PTV3_FULL_POINTS` points (features xyz): an eval forward (launches
   exactly K3 14, nothing else), a train-mode forward + backward of
   mean(out ** 2) (K3 14, K3b 14) and an eval forward with `cpe='knn'` (K3
   14), each against the plain versions on the card (output within
   `PTV3_FWD_TOL` of its largest value, each gradient leaf within
   `PTV3_GRAD_TOL` of its own); the card against the port's CPU on the same
   weights (every stage's serialization orders identical, the forward
   within `PTV3_FWD_TOL`); forward and forward + backward medians, peak
   memory and device ops;
19. man_eval: a devkit-format MAN TruckScenes tree written to a temporary
   directory (`write_man_tree`: 16 test pairs of ~20-30k-point sweeps),
   evaluated with the flagship through `python -m
   pcd_reg_hregnet_torch.evaluate --dataset man --data-path <tree> --split
   test --icp point_to_plane` (its `main`, in this process): launches
   exactly K1 2, K2 4, K3 36 a forward, a finite summary, and the twist
   table it drew written under the tree, equal to the port's draw and to
   the decalibrations its results record;
20. slam: pose-graph SLAM (`pcd_reg_hregnet_torch.slam`) over
   `SLAM_KEYFRAMES` keyframes of `N_POINTS` points (one synthetic world
   scene seen from a chain of drifting poses, the port's numpy twist draw at
   the training bounds; the odometry chain and `SLAM_LOOPS` loop closures):
   the trained flagship registers the edges in B<=8 forwards
   (`slam.model_register_fn`, launches exactly 2/4/36 a forward);
   `optimize` on the card lowers chi2 and agrees with the port's CPU solve,
   `distributed_optimize` and `schur_optimize` (one partition) on a
   one-rank NCCL group agree with it (`SLAM_SOLVE_TOL`); the trajectory's
   errors are printed; a sequence drifting at `SLAM_ICP_SCALE` of the
   bounds, registered by point-to-plane ICP from the identity, recovers its
   ground truth within `SLAM_ICP_TOL`;
21. dp_train: `train.loop.fit` of `reg_v11` from the flagship on a
   one-rank NCCL group, `DP_STEPS` steps at B=8 (launches exactly
   2/4/36/36 a step), one step bit-identical to the same step without the
   group (loss, gradients, BatchNorm statistics), and its median step time
   beside phase 6's;
22. cli: `python -m pcd_reg_hregnet_torch` on the card, through
   `cli.main` in this process with each command's launches counted:
   `infer --icp point_to_plane` on two synthetic test pairs (exactly
   2/4/36 each) bit-identical to `serve.infer_pair`, `eval --icp-only` on
   the synthetic test split (no launch) with a finite summary, and
   `train --experiment reg_v11 --max-steps 2 --lr 1e-4` (exactly
   2/4/36/36 a step plus its validation's forwards) whose checkpoint meta
   records the options;
23. seq_eval: the flagship with its PTv3 encoders sequence-sharded
   (`seq_axis`, `parallel/sequence.py`) on a one-rank NCCL group: one B=8
   `serve.register` under `sequence_mesh` (launches exactly 2/4/36, K3 on
   the rank's own patches, its row count per call printed) with poses
   within `SEQ_TOL` of the unsharded forward's, then
   `evaluate(seq_parallel=1)` of the synthetic test split with
   point-to-plane ICP (exactly 2/4/36 a forward) with summaries within
   `SEQ_TOL` of the eval phase's; each says whether it was bit-identical.
   One GPU: more ranks run only on gloo CPU ranks (`tests/`);
24. none_eval: phase 5 for the `reg_v11` checkpoint trained with
   `ptv3_cpe='none'` (`port_assets/r4_v11_none_best_rre.npz`) against
   `port_assets/v11_none_r4_eval_jax_cpu.json`, limits
   `NONE_EVAL_MAX_OUTSIDE` and `NONE_EVAL_SUMMARY_TOL`.

Ends with a JSON line of per-kernel numbers, the card's name and power
limit, the total seconds, and the result line.  In the JSON line, `ms`,
`plain_ms`, `bound_ms` and `library_ms` add up the kernel's calls in one
B=8 pair-forward (both towers; for K3b, the backward of one B=8 train
step); `launches` is the sum of the counts over the main paths of phases
4-24, each counted from 0 (K3 and K3b per dtype: the f32 rows count f32
launches only).  Exits non-zero, with no
result line, when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# [R, H, K, d] checked for correctness only in bf16, each on the wgmma
# route of K3b (csrc/attention_bwd_bf16.cu): K = 1, one ragged key tile,
# clusters of 8 and of 5 key tiles (the last ragged)
ATTN_OPENED_WGMMA = ((1, 1, 1, 8), (2, 2, 33, 32), (2, 2, 512, 32), (2, 2, 300, 64))
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
# The trained A1 checkpoint (reg_v6, model_v2) against the JAX package's CPU
# eval of it.  Limits set as the flagship's: the port's CPU eval against the
# same file puts 3 pairs outside at layer_0, 1 at layer_1 and 0 at layer_2
# (tools/compare_evals.py; weighted-FPS near-ties as for the flagship); the
# coarse limit is those 3 plus the 2 the finer layers allow.
A1_EVAL_REFERENCE = 'port_assets/v6_r4_eval_jax_cpu.json'
A1_EVAL_MAX_OUTSIDE = {'layer_0': 5, 'layer_1': 2, 'layer_2': 2, 'layer_3': 2}
# every other registration experiment, seeded weights at full width
PRESETS = ('reg_v0', 'reg_v1', 'reg_v2', 'reg_v3', 'reg_v4', 'reg_v5', 'reg_v7', 'reg_v8',
           'reg_v9', 'reg_v10', 'reg_v12', 'reg_v13', 'baseline')
# K3b against its plain backward: max |err| of each of dq, dk, dv over that
# tensor's max |value| (f32 sums in another order; the forward's 1e-5 is
# absolute on outputs of order 1, gradients reach ~1e2 at K = 256)
ATTN_BWD_TOL = 1e-4
ATTN_BWD_TOL_BF16 = 2e-2   # K3b in bf16: K3's bf16 tolerance, of each gradient's largest value
# K3's log-sum-exp of each query row (values ~1-10) against the plain one:
# absolute, f32 round-off of the running max and sum
ATTN_LSE_TOL = 1e-5
TRAIN_STEPS = 20        # optimizer steps of the counted `fit` (reg_v11 from the flagship)
TRAIN_VAL_PAIRS = 16    # its validation: the first pairs of the val split
TRAIN_TIMED = 8         # synced steps timed after it
TRAIN_LOSS_TOL = 1e-4   # kernels vs plain versions, one step: loss, relative
TRAIN_GRAD_TOL = 1e-3   # and each gradient, of the global gradient norm
EVAL_RRE_TOL = 0.005            # deg, each layer's summary
EVAL_RTE_TOL = 1e-3             # m
EVAL_RECALL_TOL = 2 / 256
FEATS_REFERENCE = 'port_assets/feats_desc_r5_feats_jax_cpu.json'
# The descriptor checkpoint's per-pair feats losses against the JAX-CPU
# ones, relative.  The port's CPU forward (tools/compare_feats.py) puts 5
# of the 16 pairs outside 1e-3 and none outside 3.1e-3: its decalibrated
# source differs from JAX's by f32 rounding (~1e-5 m), which moves a few
# points across a 1 cm PTv3 serialisation cell and so changes their
# descriptors, and 3 pairs (0, 5, 15) take other level-3 keypoints (a
# weighted-FPS near-tie, decided by the last bits of sigma).  The gate: no
# pair outside 1e-2; of the pairs that take JAX's level-3 keypoints, at
# most the CPU's 3 (8, 9, 14) plus 2 outside 1e-3; the near-tie pairs are
# allowed as a count, and the kernels must not be what decides them: on
# the card, the plain versions of the kernels pick the same keypoints and
# give each loss within `TRAIN_LOSS_TOL`.
FEATS_PAIR_RTOL = 1e-3
FEATS_MAX_OUTSIDE = 5
FEATS_ANY_RTOL = 1e-2
FEATS_STEPS = 4          # optimizer steps of each counted feats stage
FEATS_DET_BATCH = 16     # the detector stage's batch (ckpts/r5_feats_det_*: B=16)
# The warm-started reg_v11 checkpoint against the JAX package's CPU eval of
# it.  The port's CPU eval (tools/compare_evals.py) puts 86 / 23 / 11 pairs
# outside the per-pair gate at layers 0 / 1 / 2 (ICP keeps every network
# pose in the JAX eval, so layer 3 takes layer 2's): this checkpoint, 5
# epochs from the feats warm start, picks another L1-L3 keypoint than JAX
# on 12 of its first 24 test pairs even from bit-identical inputs
# (near-ties; tools/probe_near_ties.py), and its coarse Kabsch magnifies
# f32 rounding to ~5e-4 in R where the keypoints agree.  At such counts the flagship's "CPU count plus 2" is below the
# binomial spread of another device's count, so each limit is the CPU count
# plus max(2, 3 binomial standard deviations).  Those flips move the
# summary too: the per-pair differences put the standard deviation of the
# mean difference at 0.00359 / 0.00183 / 0.00154 deg (rre), 0.00189 /
# 0.00099 / 0.00082 m (rte) and 0.0055 / 0 / 0 (recall) at layers 0 / 1 /
# 2 (tools/compare_evals.py), so the flagship's 1e-3 m holds another
# correct implementation only about two times in three.  Each summary limit is the
# flagship's gate or 3 of those standard deviations, the larger
# (`WARM_EVAL_SUMMARY_TOL`; layer 3 takes layer 2's).
WARM_EVAL_REFERENCE = 'port_assets/v11_warm_r4_eval_jax_cpu.json'
WARM_EVAL_MAX_OUTSIDE = {'layer_0': 109, 'layer_1': 37, 'layer_2': 21, 'layer_3': 21}
WARM_EVAL_SUMMARY_TOL = {'layer_0': (0.0108, 0.0057, 0.0166),
                         'layer_1': (0.0055, 0.0030, EVAL_RECALL_TOL),
                         'layer_2': (EVAL_RRE_TOL, 0.0025, EVAL_RECALL_TOL),
                         'layer_3': (EVAL_RRE_TOL, 0.0025, EVAL_RECALL_TOL)}
WARM_STEPS = 4           # optimizer steps of the counted warm start
# the bf16 compute path (phases bf16_serve, bf16_eval, bf16_train), each
# limit set from the CPU evals and steps before the first card run
BF16_EVAL_REFERENCE = 'port_assets/v11_r5_eval_bf16_jax_cpu.json'
# The flagship in bf16 against the JAX package's CPU eval in bf16.  The
# port's CPU bf16 eval (`python -m pcd_reg_hregnet_torch.evaluate --device
# cpu --compute-dtype bfloat16 --icp point_to_plane`, 3644-4377 s) puts
# 245 / 177 / 151 / 151 of 256 pairs outside the per-pair gate at layers
# 0-3 (tools/compare_evals.py):
# bf16 moves a pose by ~1e-2 m (median |dt| 1.2 cm at layer 2), and near-ties
# in bf16 descriptors and sigmas decide the coarse layer; JAX's own bf16
# eval is farther from its f32 eval (256 / 235 / 199 / 199).  Each limit is
# the CPU count plus max(2, 3 binomial standard deviations); each summary
# limit the flagship's gate or 3 standard deviations of the CPU eval's mean
# difference (rre 0.03554 / 0.00582 / 0.00246 deg, rte 0.02208 / 0.00106 /
# 0.00077 m, recall 0.02278 / 0.00677 / 0), the larger.
BF16_EVAL_MAX_OUTSIDE = {'layer_0': 254, 'layer_1': 199, 'layer_2': 174, 'layer_3': 174}
BF16_EVAL_SUMMARY_TOL = {'layer_0': (0.1067, 0.0663, 0.0684),
                         'layer_1': (0.0175, 0.0032, 0.0204),
                         'layer_2': (0.0074, 0.0024, EVAL_RECALL_TOL),
                         'layer_3': (0.0074, 0.0024, EVAL_RECALL_TOL)}
# At such counts the gate above holds little, so a second per-pair gate is
# sized for bf16: R 5e-3 / t 5e-2 m at layers 1-3 (bf16 moves a pose by
# ~1e-2 m, median |dt| 1.2 cm at layer 2) and R 2e-2 / t 0.25 m at the
# coarse layer 0 (|dt| 90th percentile 0.24 m: its near-ties).  The port's
# CPU bf16 eval puts 24 / 11 / 5 / 5 pairs outside it at layers 0-3
# (tools/compare_evals.py --tol); each limit is that count plus max(2, 3
# binomial standard deviations).  A fault that moves every pose by a few
# cm fails it.
BF16_EVAL_PAIR_GATE = {'layer_0': (2e-2, 0.25, 38), 'layer_1': (5e-3, 5e-2, 21),
                       'layer_2': (5e-3, 5e-2, 12), 'layer_3': (5e-3, 5e-2, 12)}
# bf16_serve's card-vs-CPU poses at B=1 by level (R entries, t m), set from
# the port's own card-vs-CPU bf16 spread: `tools/bf16_device_spread.py
# --pairs 16` (H100, 700 W) puts the largest at 4.7e-4 / 0.036 m (L1),
# 2.0e-3 / 0.043 m (L2) and 2.4e-2 / 0.44 m (L3, whose keypoints the
# weighted-FPS near-ties of bf16 sigmas pick differently in every pair).
# L1 and L2 at about three times the largest; L3 at the largest with room.
BF16_POSE_TOL = {3: (5e-2, 0.5), 2: (6e-3, 0.13), 1: (1.5e-3, 0.1)}
# bf16_train's kernels-vs-plain step (loss relative, each gradient of the
# global norm).  K3's bf16 path rounds the unnormalised probabilities to
# bf16 as P.V's operand and K3b rounds p and dS as operands
# (FlashAttention-2's rounding; the TPU kernel and its `_bwd` keep p in
# f32, so this is the port's one stated difference in the attention); the
# plain versions round only their outputs.
# `tools/bf16_step_spread.py --kernel-rounding 4 --batch 8` emulates those
# roundings on the CPU, the flagship at full width on the first 4 train
# batches: loss 0.02-1.84% apart, max |dgrad| 0.23-2.01% of the norm,
# keypoints identical; the same plain step on coordinates one f32 ulp away
# moves by 1.05-4.74% / 2.84-5.70% (the bf16 step's own sensitivity, not
# the kernels').  Limits: twice the largest emulated.  (The first limit,
# 1e-2 / 1e-2, came from the JAX attention's rounding on one B=2 batch,
# loss 0.18%, and failed on the card at loss 1.52%: it held the JAX
# model's rounding, not the kernels'.)
BF16_TRAIN_TOL = (3.7e-2, 4e-2)
# ptv3_full: the full PointTransformerV3 (encoder-decoder, z and Hilbert
# orders, serialized pooling) at the JAX module's defaults, seeded weights,
# on B=8 synthetic test scenes of 8192 points (the multiple of 1024, patch
# 128 after three stride-2 poolings, nearest the flagship's 8096)
PTV3_FULL = dict(enc_channels=(32, 64, 128, 256), enc_depths=(2, 2, 2, 2),
                 enc_heads=(2, 4, 8, 16), dec_channels=(64, 64, 128), dec_depths=(2, 2, 2),
                 dec_heads=(4, 4, 8), patch_size=128, stride=2, mlp_ratio=4.0, grid_size=0.01,
                 orders=('z', 'hilbert'))
PTV3_FULL_POINTS = 8192
PTV3_FULL_REPS = 10
# kernels against plain versions, and the card against the port's CPU:
# the output within 1e-4 of its largest value, each gradient leaf within
# 1e-3 of its own largest value.  A bias ahead of a train-mode BatchNorm has
# a gradient of exactly zero (the batch mean removes it); its f32 round-off
# is held below `PTV3_ZERO_GRAD` of the largest gradient anywhere instead
# (as in tests/test_torch_ptv3_full.py).
PTV3_FWD_TOL = 1e-4
PTV3_GRAD_TOL = 1e-3
PTV3_ZERO_GRAD = 1e-5
# man_eval: a devkit-format MAN TruckScenes tree written here (numpy and
# json), evaluated with the flagship through `python -m
# pcd_reg_hregnet_torch.evaluate --dataset man --data-path`
MAN_SCENES = {'train': 2, 'val': 1, 'test': 2}
MAN_SAMPLES = 8          # samples per scene: 16 test pairs
MAN_SWEEP_POINTS = (20000, 30000)
# slam: 16 keyframes of one synthetic world scene, each in its own frame
SLAM_KEYFRAMES = 16
SLAM_LOOPS = 3           # loop closures beside the odometry chain: 18 edges
SLAM_ICP_SCALE = 0.125   # the ICP sequence drifts at this share of the training bounds
SLAM_ICP_TOL = (0.5, 0.05)      # deg, m: the ICP sequence against its ground truth
SLAM_SOLVE_TOL = 1e-3    # pose entries: card vs CPU solve, sharded / Schur vs dense
SLAM_ITERS = 10
DP_STEPS = 2             # optimizer steps of the counted data-parallel `fit`
DP_TIMED = 6             # synced steps timed on the one-rank group
# seq_eval: the flagship with its PTv3 encoders sequence-sharded on a
# one-rank NCCL group against the unsharded forward and the eval phase
SEQ_TOL = 1e-6           # poses and each summary entry
SEQ_TIMED = 5            # forwards timed each way
# none_eval: the reg_v11 checkpoint trained with ptv3_cpe='none' against
# the JAX package's CPU eval of it.  The port's CPU eval
# (tools/compare_evals.py) puts 30 / 24 / 14 / 14 pairs outside the
# per-pair gate at layers 0-3: this checkpoint registers far worse than the
# flagship (layer 3 rre 1.53 deg, 31% of pairs beyond the recall bounds),
# and a pair near its failure edge moves by more than the gate on another
# keypoint pick.  Each limit is the CPU count plus max(2, 3 binomial
# standard deviations), as for the warm checkpoint.  The per-pair
# differences put the standard deviation of the mean difference at
# 0.00668 / 0.00499 / 0.00329 deg (rre), 0.00161 / 0.00159 / 0.00139 m
# (rte) and 0 / 0.00391 / 0.00391 (recall) at layers 0 / 1 / 2; each
# summary limit is the flagship's gate or 3 of those, the larger (layer 3
# takes layer 2's).
NONE_EVAL_REFERENCE = 'port_assets/v11_none_r4_eval_jax_cpu.json'
NONE_EVAL_MAX_OUTSIDE = {'layer_0': 46, 'layer_1': 38, 'layer_2': 25, 'layer_3': 25}
NONE_EVAL_SUMMARY_TOL = {'layer_0': (0.0201, 0.0049, EVAL_RECALL_TOL),
                         'layer_1': (0.0150, 0.0048, 0.0118),
                         'layer_2': (0.0099, 0.0042, 0.0118),
                         'layer_3': (0.0099, 0.0042, 0.0118)}
REPORT: dict = {}        # phase -> numbers the bf16 phases print beside the f32 ones


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


def check_attention(torch, lib, kattn, gen, t0) -> list:
    """K3: its tiling against the compiled one; every (K, d) of the forward
    at B=8 and B=1 (R = 4B), f32 and bf16, against the plain version, timed
    beside SDPA (in the same dtype) and its bounds, with the sweep of query
    rows per block; the shapes the first K3 refused, and strided views, for
    correctness.  Returns the f32 and the bf16 rows of the `kernels` line,
    each the calls of one B=8 forward in that compute dtype."""
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
    acc = {dt: {'tot': {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0},
                'dev': 0.0, 'lib_dev': 0.0, 'bound_67': 0.0, 'max_err': 0.0,
                'by': {'bytes': 0.0, 'operations': 0.0}}
           for dt in (torch.float32, torch.bfloat16)}
    ptv3 = ptv3_full_shapes(BATCH)
    ptv3_acc = {'ms': 0.0, 'dev': 0.0, 'lib_dev': 0.0, 'bound': 0.0}
    cases = [('flagship', B, shape, dtype) for B in (BATCH, 1) for shape in shapes(B)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [('ptv3_full', BATCH, shape, torch.float32) for shape in ptv3]
    for path, B, (R, H, K, d), dtype in cases:
        scale = d ** -0.5
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
        log('kernels', t0, f'patch_attention {path} B={B} R={R} H={H} K={K} d={d} '
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
        if path == 'ptv3_full':   # per ptv3_full forward: its launches of the shape
            n = ptv3[(R, H, K, d)]
            for key, x in (('ms', ms), ('dev', dev), ('lib_dev', lib_dev),
                           ('bound', bound)):
                ptv3_acc[key] += n * x
        elif B == BATCH:   # per forward, in the forward's compute dtype
            n, a = ATTN_DEPTH * TOWERS, acc[dtype]
            a['tot']['ms'] += n * ms
            a['tot']['plain_ms'] += n * plain_ms
            a['tot']['library_ms'] += n * lib_ms
            a['tot']['bound_ms'] += n * bound
            a['dev'] += n * dev
            a['lib_dev'] += n * lib_dev
            a['bound_67'] += n * max(b_bytes, b_67)
            a['max_err'] = max(a['max_err'], err)
            a['by'][kind] += bound
    for dtype, a in acc.items():
        route = '3xTF32' if dtype == torch.float32 else 'bf16 tensor cores'
        log('kernels', t0, f'patch_attention per B={BATCH} forward ({str(dtype)[6:]}): back to '
            f'back: kernel {a["tot"]["ms"]:.4f} ms, sdpa {a["tot"]["library_ms"]:.4f} ms, plain '
            f'{a["tot"]["plain_ms"]:.4f} ms; device time: kernel {a["dev"]:.4f} ms, sdpa '
            f'{a["lib_dev"]:.4f} ms; bound {a["tot"]["bound_ms"]:.4f} ms ({route}), '
            f'{a["bound_67"]:.4f} ms (67 TFLOP/s)')

    log('kernels', t0, f'patch_attention per ptv3_full B={BATCH} forward (f32, '
        f'{sum(ptv3.values())} launches): back to back {ptv3_acc["ms"]:.4f} ms; device time: '
        f'kernel {ptv3_acc["dev"]:.4f} ms, sdpa {ptv3_acc["lib_dev"]:.4f} ms; bound '
        f'{ptv3_acc["bound"]:.4f} ms (3xTF32), share {ptv3_acc["bound"] / ptv3_acc["dev"]:.1%}')
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
    return [{'name': 'patch_attention' + ('' if dtype == torch.float32 else '_bf16'),
             'route': 'cuda', 'source': 'pcd_reg_hregnet_torch/csrc/attention.cu',
             'replaces': 'pcd_reg_hregnet_tpu/ops/pallas/attention.py:31',
             'max_abs_err': a['max_err'], 'bound_by': max(a['by'], key=a['by'].get), **a['tot']}
            for dtype, a in acc.items()]


def attn_bwd_bounds(R, H, K, d, esize=4):
    """(bytes, operations) times in ms of one K3b call: q, k, v, o, g read
    once and dq, dk, dv written once over HBM (4 or 2 bytes each; in bf16
    also the f32 log-sum-exp); the five K*K*d products (s, recomputed since
    p is not an input, then dp, dv, dq, dk) on the tensor cores, what the
    kernel runs them on: at 3xTF32 (495/3 TFLOP/s) in f32, at the bf16 peak
    in bf16; also returned, third, the operations against the 67 TFLOP/s of
    f32 on the CUDA cores (the route of the kernel's first, two-pass
    version)."""
    nbytes = 8 * R * H * K * d * esize + (4 * R * H * K if esize == 2 else 0)
    flops = 10 * R * H * K * K * d
    rate = TF32_FLOPS_S / 3 if esize == 4 else BF16_FLOPS_S
    return (nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3, flops / F32_FLOPS_S * 1e3)


def check_attention_backward(torch, lib, kattn, gen, t0, dtype=None) -> dict:
    """K3b in `dtype` (f32 by default, or bf16): its tilings against the
    compiled ones; against the plain backward (f32 inside, `ATTN_BWD_TOL`
    of each gradient's largest value; bf16 `ATTN_BWD_TOL_BF16`) at every
    (K, d) of the train step at B=8 and B=1 and at every `ATTN_OPENED`
    shape, in every block tiling, on fresh
    strided views (q, k, v of a [R, K, 3, H, d] projection, g of an
    [R, K, H, d] gradient, dq, dk, dv into one [R, K, 3, H, d] buffer), with
    the log-sum-exp that K3 writes held against the plain one; two calls on
    the same inputs bit-identical; timed per train step (36 calls at B=8)
    back to back and as device time, beside its bounds and the backward of
    SDPA on the same shapes and dtype, with the sweep of block tilings."""
    import ctypes

    from pcd_reg_hregnet_torch.time_attention import call_ms, device_ms, shapes
    F = torch.nn.functional
    dtype = dtype or torch.float32
    name = str(dtype).split('.')[-1]
    tol = ATTN_BWD_TOL if dtype == torch.float32 else ATTN_BWD_TOL_BF16
    a, b, c, e = (ctypes.c_int() for _ in range(4))
    compiled = []
    while lib.lib.pcdreg_attention_bwd_tiling(len(compiled), a, b) > 0:
        compiled.append((a.value, b.value))
    if tuple(compiled) != kattn.BWD_TILES:
        raise AssertionError(f'csrc/attention_bwd.cu tilings {compiled} differ from '
                             f'ops/kernels/attention.py BWD_TILES {kattn.BWD_TILES}')
    bm, st, cl = (ctypes.c_int() for _ in range(3))
    for K in (1, 33, 64, 100, 128, 256, 512, 513, 1024):
        for d in (1, 5, 8, 16, 24, 32, 64, 100, 128, 129, 256, 300):
            if dtype == torch.bfloat16:   # the route, by shape: the wgmma kernel's plan or -1
                p = kattn.plan_backward(1, 1, K, d, dtype=dtype)
                smem = lib.lib.pcdreg_attention_bwd_bf16_plan(K, d, a, bm, st, cl)
                got = ('wgmma' if smem >= 0 else 'mma', smem, a.value, bm.value, st.value,
                       cl.value)
                if got[0] != p.route or p.route == 'wgmma' and got[1:] != (
                        p.smem, p.dp, p.bm, p.stages, p.cluster):
                    raise AssertionError(f'attention backward bf16 plan K={K} d={d}: csrc '
                                         f'(route, smem, dp, bm, stages, cluster) {got} != '
                                         f'ops/kernels {p}')
            for tile in kattn.backward_tilings(K, d, dtype):
                p = kattn.plan_backward(1, 1, K, d, tile, dtype=dtype)
                smem = lib.lib.pcdreg_attention_bwd_plan(K, d, *tile, kattn._DTYPE_CODES[dtype],
                                                         a, b, c, e)
                got = (smem, a.value, b.value, c.value, e.value)
                if got != (p.smem, p.dp, p.bm, p.stages, p.cluster):
                    raise AssertionError(f'attention backward plan K={K} d={d} {tile} {name}: '
                                         f'csrc (smem, dp, bm, stages, cluster) {got} != '
                                         f'ops/kernels {p}')
    tot = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0}
    dev_step = lib_dev_step = bound_67 = 0.0
    max_err = 0.0
    by = {'bytes': 0.0, 'operations': 0.0}

    def case(R, H, K, d):
        """Inputs at [R, H, K, d] and the worst max |err| / max |value| of
        dq, dk, dv over every tiling, each launched twice (bit-identical)."""
        scale = d ** -0.5
        qkv = torch.randn((R, K, 3, H, d), generator=gen).to('cuda', dtype)
        q, k, v = kattn.unpack_qkv(qkv)
        lse = torch.empty((R, H, K), device='cuda')
        o = kattn.patch_attention(q, k, v, scale, lse=lse)
        g = torch.randn((R, K, H, d), generator=gen).to('cuda', dtype).transpose(1, 2)
        ref = kattn.patch_attention_backward_reference(q, k, v, g, scale)
        lse_err = float((lse - kattn.attention_lse_reference(q, k, scale)).abs().max())
        if not lse_err <= ATTN_LSE_TOL:
            raise AssertionError(f'patch_attention lse {(R, H, K, d)}: max |err| {lse_err} '
                                 f'> {ATTN_LSE_TOL}')
        worst = 0.0
        for tile in [None, *kattn.backward_tilings(K, d, dtype)]:
            bufs = [torch.empty_like(qkv) for _ in range(2)]
            for buf in bufs:
                if tile is None:   # the wrapper, as the train step calls it
                    kattn.patch_attention_backward(q, k, v, o, g, scale,
                                                   out=kattn.unpack_qkv(buf), lse=lse)
                else:
                    kattn._launch_backward(q, k, v, o, g, scale, kattn.unpack_qkv(buf), lse,
                                           tile)
            torch.cuda.synchronize()
            errs = [float((x.float() - y.float()).abs().max()
                          / y.float().abs().max().clamp_min(1e-30))
                    for x, y in zip(kattn.unpack_qkv(bufs[0]), ref)]
            if not max(errs) <= tol:
                raise AssertionError(f'patch_attention_backward {(R, H, K, d)} {name} tiling '
                                     f'{tile}: max |err| / max |value| of dq, dk, dv {errs} > '
                                     f'{tol}')
            if not torch.equal(bufs[0], bufs[1]):
                raise AssertionError(f'patch_attention_backward {(R, H, K, d)} tiling {tile}: '
                                     f'two calls on the same inputs differ')
            worst = max(worst, *errs)
        return (q, k, v, o, g, lse), worst, lse_err

    ptv3 = ptv3_full_shapes(BATCH) if dtype == torch.float32 else {}
    ptv3_acc = {'ms': 0.0, 'dev': 0.0, 'lib_dev': 0.0, 'bound': 0.0}
    cases = [('train', B, shape) for B in (BATCH, 1) for shape in shapes(B)]
    cases += [('ptv3_full', BATCH, shape) for shape in ptv3]
    for path, B, (R, H, K, d) in cases:
        (q, k, v, o, g, lse), err, lse_err = case(R, H, K, d)
        scale = d ** -0.5

        def kern():
            return kattn.patch_attention_backward(q, k, v, o, g, scale, lse=lse)
        ms = call_ms(kern, 20)
        dev = device_ms(kern, 20)
        plain_ms = call_ms(lambda: kattn.patch_attention_backward_reference(
            q, k, v, g, scale), 20)
        qs, ks, vs = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        gs = g.contiguous()
        side = torch.cuda.Stream()   # autograd runs the backward on the forward's stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qs, ks, vs), gs, retain_graph=True)
        lib_ms = call_ms(sdpa_bwd, 20, side)
        lib_dev = device_ms(sdpa_bwd, 20, side)
        b_bytes, b_ops, b_67 = attn_bwd_bounds(R, H, K, d, q.element_size())
        bound = max(b_bytes, b_ops)
        kind = 'bytes' if b_bytes >= b_ops else 'operations'
        p = kattn.plan_backward(R, H, K, d, sms=torch.cuda.get_device_properties(0)
                                .multi_processor_count, dtype=dtype)
        route = '3xTF32' if dtype == torch.float32 else 'bf16 tensor cores'
        tiling = (f'route {p.route}, tiling {(p.bn, p.qs)}' if p.route == 'mma' else
                  f'route {p.route}, {p.bn} keys x {p.bm} query rows, {p.stages} stages')
        log('kernels', t0, f'patch_attention_backward {path} B={B} R={R} H={H} K={K} d={d} '
            f'{name}: '
            f'max|err|/max|value| {err:.2e} (every tiling, two calls bit-identical), lse '
            f'max|err| {lse_err:.2e}; back to back: kernel {ms * 1e3:.2f} us, plain '
            f'{plain_ms * 1e3:.2f} us, sdpa backward {lib_ms * 1e3:.2f} us; device time: '
            f'kernel {dev * 1e3:.2f} us ({tiling}, cluster {p.cluster}), sdpa '
            f'backward {lib_dev * 1e3:.2f} us; bound {bound * 1e3:.2f} us ({kind}, {route}), '
            f'{max(b_bytes, b_67) * 1e3:.2f} us (67 TFLOP/s); share of bound {bound / dev:.1%}')
        sweep = {t: device_ms(lambda t=t: kattn._launch_backward(
            q, k, v, o, g, scale, None, lse, t), 20)
            for t in kattn.backward_tilings(K, d, dtype)}
        if sweep:
            log('kernels', t0, '  sweep (bn, qs), device time: ' + ', '.join(
                f'{t} {x * 1e3:.2f} us' for t, x in sweep.items()))
        best = min(sweep, key=sweep.get) if sweep else None
        if sweep and sweep[(p.bn, p.qs)] > 1.05 * sweep[best]:
            log('kernels', t0, f'  note: plan_backward\'s {(p.bn, p.qs)} reads '
                f'{sweep[(p.bn, p.qs)] / sweep[best] - 1:.0%} slower than {best}')
        if path == 'ptv3_full':   # per ptv3_full backward: its launches of the shape
            n = ptv3[(R, H, K, d)]
            for key, x in (('ms', ms), ('dev', dev), ('lib_dev', lib_dev), ('bound', bound)):
                ptv3_acc[key] += n * x
        elif B == BATCH:   # per train step: two blocks per stage, two towers
            n = ATTN_DEPTH * TOWERS
            tot['ms'] += n * ms
            tot['plain_ms'] += n * plain_ms
            tot['library_ms'] += n * lib_ms
            tot['bound_ms'] += n * bound
            dev_step += n * dev
            lib_dev_step += n * lib_dev
            bound_67 += n * max(b_bytes, b_67)
            max_err = max(max_err, err)
            by[kind] += bound
    log('kernels', t0, f'patch_attention_backward per B={BATCH} train step ({name}): back to '
        f'back: kernel {tot["ms"]:.4f} ms, sdpa backward {tot["library_ms"]:.4f} ms, plain '
        f'{tot["plain_ms"]:.4f} ms; device time: kernel {dev_step:.4f} ms, sdpa backward '
        f'{lib_dev_step:.4f} ms; bound {tot["bound_ms"]:.4f} ms ({route}; share '
        f'{tot["bound_ms"] / dev_step:.1%}), {bound_67:.4f} ms (67 TFLOP/s f32)')
    if ptv3:
        log('kernels', t0, f'patch_attention_backward per ptv3_full B={BATCH} backward ({name}, '
            f'{sum(ptv3.values())} launches): back to back {ptv3_acc["ms"]:.4f} ms; device '
            f'time: kernel {ptv3_acc["dev"]:.4f} ms, sdpa backward {ptv3_acc["lib_dev"]:.4f} ms; '
            f'bound {ptv3_acc["bound"]:.4f} ms ({route}), share '
            f'{ptv3_acc["bound"] / ptv3_acc["dev"]:.1%}')
    wgmma = ATTN_OPENED_WGMMA if dtype == torch.bfloat16 else ()
    for shape in ATTN_OPENED + wgmma:
        route = kattn.backward_route(shape[2], shape[3], dtype)
        if shape in wgmma and route != 'wgmma':
            raise AssertionError(f'patch_attention_backward {shape} {name}: route {route}, '
                                 f'not the wgmma route this shape is to check')
        _, err, lse_err = case(*shape)
        log('kernels', t0, f'patch_attention_backward {shape} {name}: route {route}, '
            f'max|err|/max|value| {err:.2e} over every tiling, two calls bit-identical; lse '
            f'max|err| {lse_err:.2e}')
    if dtype == torch.bfloat16:   # views that break TMA's 16-byte rule: the wrapper copies them
        R, H, K, d = 2, 3, 100, 32
        q, k, v, g = (torch.randn((R, H, K, d + 4), generator=gen).to('cuda', dtype)[..., :d]
                      for _ in range(4))
        lse = torch.empty((R, H, K), device='cuda')
        o = kattn.patch_attention(q, k, v, d ** -0.5, lse=lse)
        got = kattn.patch_attention_backward(q, k, v, o, g, d ** -0.5, lse=lse)
        ref = kattn.patch_attention_backward_reference(q, k, v, g, d ** -0.5)
        errs = [float((x.float() - y.float()).abs().max() / y.float().abs().max())
                for x, y in zip(got, ref)]
        if not max(errs) <= tol:
            raise AssertionError(f'patch_attention_backward on [R, H, K, d + 4][..., :d] views '
                                 f'{(R, H, K, d)}: max |err| / max |value| {errs} > {tol}')
        log('kernels', t0, f'patch_attention_backward on views with 72-byte rows {(R, H, K, d)} '
            f'{name}: route {kattn.backward_route(K, d, dtype)}, max|err|/max|value| '
            f'{max(errs):.2e}')
    return {'name': 'patch_attention_bwd' + ('' if dtype == torch.float32 else '_bf16'),
            'route': 'cuda',
            'source': 'pcd_reg_hregnet_torch/csrc/attention_bwd' + (
                '.cu' if dtype == torch.float32 else '_bf16.cu'),
            'replaces': 'pcd_reg_hregnet_tpu/ops/pallas/attention.py:93',
            'max_abs_err': max_err, 'bound_by': max(by, key=by.get), **tot}


def per_forward_launches(cfg) -> dict:
    """Each kernel's launches in one pair-forward (both towers), K3 under
    its compute dtype's name."""
    attn = TOWERS * len(cfg.levels) * sum(cfg.ptv3_depths) if cfg.backbone == 'ptv3' else 0
    bf16 = cfg.compute_dtype == 'bfloat16'
    return {'fps': TOWERS,
            'weighted_fps': TOWERS * (len(cfg.levels) - 1),
            'patch_attention': 0 if bf16 else attn,
            'patch_attention_bf16': attn if bf16 else 0,
            'patch_attention_bwd': 0,
            'patch_attention_bwd_bf16': 0}


def _bwd_key(cfg) -> str:
    return 'patch_attention_bwd_bf16' if cfg.compute_dtype == 'bfloat16' else 'patch_attention_bwd'


def per_step_launches(cfg) -> dict:
    """Each kernel's launches in one train step of the experiment `cfg`: a
    pair-forward, and the backward of each attention whose level reaches an
    optimised loss.  A level's PTv3 descriptors reach the pose loss through
    its own correspondences; with the pose loss detached, the chamfer loss
    (the coarse pose moves the L2 keypoints) and the circle loss reach L3
    only, the MI loss L3 and L2 (FineReg2's inputs follow the coarse pose),
    or L3 alone when it comes from the coarse level."""
    per = per_forward_launches(cfg.model)
    lc = cfg.loss
    levels = set()
    if lc.transformation and not lc.detach_transformation:
        levels |= {1, 2, 3}
    if lc.chamfer or lc.circle:
        levels |= {3}
    if lc.mi:
        levels |= {3} if cfg.model.mi_from_coarse else {2, 3}
    attn = per['patch_attention'] + per['patch_attention_bf16']
    per_level = attn // len(cfg.model.levels)
    return dict(per, **{_bwd_key(cfg.model): per_level * len(levels)})


KERNELS = ('fps', 'weighted_fps', 'patch_attention', 'patch_attention_bf16',
           'patch_attention_bwd', 'patch_attention_bwd_bf16')


def reset_launches() -> None:
    """Every kernel wrapper's launch count, per dtype too, to 0."""
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.ops.kernels import fps as kfps
    kfps.farthest_point_sample.launches = 0
    kfps.weighted_farthest_point_sample.launches = 0
    kattn.reset_counts()


def read_launches() -> dict:
    """The launches since `reset_launches`, by `KERNELS` name: K3 and K3b
    split by dtype (the f32 names count f32 launches only)."""
    import torch
    from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
    from pcd_reg_hregnet_torch.ops.kernels import fps as kfps
    fwd, bwd = (w.launches_by_dtype for w in (kattn.patch_attention,
                                               kattn.patch_attention_backward))
    return {'fps': kfps.farthest_point_sample.launches,
            'weighted_fps': kfps.weighted_farthest_point_sample.launches,
            'patch_attention': fwd[torch.float32], 'patch_attention_bf16': fwd[torch.bfloat16],
            'patch_attention_bwd': bwd[torch.float32],
            'patch_attention_bwd_bf16': bwd[torch.bfloat16]}


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


def serve_phase(torch, t0, phase: str, name: str, weights, compute_dtype=None,
                pose_tol=(POSE_TOL_R, POSE_TOL_T)) -> dict:
    """A trained checkpoint through the serving entry points on the card,
    in its own compute dtype or in `compute_dtype`: two `infer_pair`, one
    with point-to-plane ICP, one B=8 `register` (counted), forward times,
    and the card's B=1 poses against the port's CPU forward (in the same
    dtype) within `pose_tol`: (R, t m) at every level, or a dict of them by
    level (3 the coarsest)."""
    from pcd_reg_hregnet_torch import serve
    from pcd_reg_hregnet_torch.data.pipeline import range_filter, resample
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.ops.sampling import fps

    over = {} if compute_dtype is None else {'compute_dtype': compute_dtype}
    model = zoo.build(name, device='cuda', weights=weights, **over)
    cfg = model.cfg
    per_forward = per_forward_launches(cfg)
    log(phase, t0, f'{name} ({cfg.backbone} backbone) built on the card with the trained weights '
        f'of {weights.name}: {sum(p.numel() for p in model.parameters())} parameters, levels '
        f'{[lvl.nsample for lvl in cfg.levels]}'
        + (f', depths {cfg.ptv3_depths}' if cfg.backbone == 'ptv3' else '')
        + f', compute dtype {cfg.compute_dtype}')
    raw_pairs = synthetic_pairs(3)
    rng = np.random.default_rng(7)
    batch = [make_clouds(rng, N_POINTS) for _ in range(BATCH)]
    src8 = np.stack([s for s, _ in batch])
    dst8 = np.stack([d for _, d in batch])

    # --- the main path, counted -------------------------------------------
    reset_launches()
    t_main = time.perf_counter()
    poses = [serve.infer_pair(model, s, d, device='cuda') for s, d in raw_pairs[:2]]
    pose_icp = serve.infer_pair(model, *raw_pairs[2], device='cuda', icp='point_to_plane')
    out8 = serve.register(model, src8, dst8, device='cuda')
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = read_launches()
    forwards = len(raw_pairs) + 1
    log(phase, t0, f'{len(raw_pairs)} infer_pair (one with point-to-plane ICP) + 1 '
        f'register(B={BATCH}) in {main_s:.2f} s; launches {launches}')
    check_launches(launches, per_forward, forwards)
    for p in poses + [pose_icp]:
        if not np.all(np.isfinite(np.asarray(p['transform']))):
            raise AssertionError(f'non-finite pose from infer_pair: {p}')
    T_icp = np.asarray(pose_icp['transform_icp'])
    if T_icp.shape != (4, 4) or not np.all(np.isfinite(T_icp)):
        raise AssertionError(f'infer_pair(icp=point_to_plane): transform_icp {T_icp}')
    log(phase, t0, f'infer_pair with ICP: transform_icp finite, '
        f'{"refined" if np.abs(T_icp - np.asarray(pose_icp["transform"])).max() > 0 else "kept"}'
        f' by the trust gate')
    R8, t8 = out8['rotation'], out8['translation']
    if tuple(R8.shape) != (BATCH, 3, 3) or tuple(t8.shape) != (BATCH, 3):
        raise AssertionError(f'register shapes {tuple(R8.shape)} {tuple(t8.shape)}')
    if not (torch.isfinite(R8).all() and torch.isfinite(t8).all()):
        raise AssertionError('non-finite pose from register')
    if R8.dtype != torch.float32 or t8.dtype != torch.float32:
        raise AssertionError(f'register poses in {R8.dtype} / {t8.dtype}, not f32')
    log(phase, t0, f'poses finite; per forward +{per_forward["fps"]} fps, '
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
    medians = REPORT.setdefault(phase, {})
    for b, (src, dst) in ((BATCH, (src8_d, dst8_d)),
                          (1, (src8_d[:1].contiguous(), dst8_d[:1].contiguous()))):
        lo, med, hi = timed(src, dst, SERVE_REPS)
        medians[f'B={b}'] = med
        log(phase, t0, f'forward B={b}: median {med:.1f} ms ({b / med * 1e3:.1f} pairs/s), '
            f'min {lo:.1f}, max {hi:.1f} over {SERVE_REPS} forwards after one warm-up '
            f'(host clock; indicative only)'
            + (f'; f32 serve phase {REPORT["serve"][f"B={b}"]:.1f} ms'
               if compute_dtype and 'serve' in REPORT else ''))

    knn_order_cost(torch, t0, phase, model, src8_d, dst8_d)

    # --- the card against the port's CPU forward, B=1 ----------------------
    prep = []
    rng_p = np.random.default_rng(0)
    for pts in raw_pairs[0]:
        pts, _ = range_filter(pts, 80.0)
        pts, _ = resample(pts, N_POINTS, rng_p)
        prep.append(pts[None])
    cpu_model = zoo.build(name, device='cpu', weights=weights, **over)
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
    log(phase, t0, 'keypoints card vs CPU, max|dxyz| (m; a keypoint chosen differently '
        'shows at its level and the coarser ones): '
        + ', '.join(f'L{lvl} {dxyz(lvl):.2e}' for lvl in (1, 2, 3)))
    failed = []
    for lvl, (Rg, tg, Rc, tc) in enumerate(zip(out_gpu['rotation'], out_gpu['translation'],
                                               out_cpu['rotation'], out_cpu['translation'])):
        level = 3 - lvl
        tol_r, tol_t = pose_tol[level] if isinstance(pose_tol, dict) else pose_tol
        dr = float((Rg.cpu() - Rc).abs().max())
        dt = float((tg.cpu() - tc).abs().max())
        log(phase, t0, f'level {level}: card vs CPU max|dR| {dr:.2e}, max|dt| {dt:.2e} m '
            f'(limits {tol_r} / {tol_t} m)')
        if not (dr <= tol_r and dt <= tol_t):
            failed.append(f'level {level}: |dR| {dr} (tol {tol_r}), |dt| {dt} (tol {tol_t})')
    if failed:
        raise AssertionError('card vs CPU poses: ' + '; '.join(failed))
    log(phase, t0, f'L1 FPS indices identical card vs CPU; poses within their limits '
        f'(CPU forward {cpu_s:.1f} s on {CPU_THREADS} threads)')
    return launches


def knn_order_cost(torch, t0, phase: str, model, src, dst) -> None:
    """What the kNN's tie order costs a forward: every kNN call of one
    forward (recorded), timed as `ops.neighbors.knn` (the JAX package's
    order of ties: a float `topk` of k + 1, the k sorted by (distance,
    index), the int64 key only for rows tied at the k-th place) and as a
    plain `torch.topk` of the same distances, each call 5 times after one
    (CUDA events), summed over the forward's calls."""
    from pcd_reg_hregnet_torch.models import layers, ptv3
    from pcd_reg_hregnet_torch.ops import neighbors

    knn, calls = neighbors.knn, []

    def record(query, database, k):
        calls.append((query, database, k))
        return knn(query, database, k)

    def topk_knn(query, database, k):
        return torch.topk(neighbors.pairwise_sqdist(query, database), k, dim=-1,
                          largest=False, sorted=True)
    saved = (neighbors.knn, layers.knn, ptv3.knn)
    try:
        neighbors.knn = layers.knn = ptv3.knn = record
        with torch.no_grad():
            model(src, dst)
    finally:
        neighbors.knn, layers.knn, ptv3.knn = saved
    with torch.no_grad():
        tie = sum(cuda_ms(torch, lambda c=c: knn(*c), 5) for c in calls)
        plain = sum(cuda_ms(torch, lambda c=c: topk_knn(*c), 5) for c in calls)
        tied = rows = 0
        for q, db, k in calls:
            if k < db.shape[1]:
                v = torch.topk(neighbors.pairwise_sqdist(q, db), k + 1, dim=-1,
                               largest=False, sorted=True).values
                tied += int((v[..., k - 1] == v[..., k]).sum())
                rows += v[..., 0].numel()
    log(phase, t0, f'kNN tie order: the {len(calls)} kNN calls of a B={src.shape[0]} forward '
        f'take {tie:.3f} ms, with a plain torch.topk {plain:.3f} ms ({tie - plain:+.3f} ms '
        f'per forward; CUDA events, device and launch time); {tied} of {rows} rows tied at '
        f'the k-th place (selected again by the int64 key)')

    def forward_ms(reps=10):
        with torch.no_grad():
            model(src, dst)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                model(src, dst)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))
    medians = {'tie': [], 'plain': []}
    for variant in ('tie', 'plain', 'plain', 'tie'):
        try:
            if variant == 'plain':
                neighbors.knn = layers.knn = ptv3.knn = topk_knn
            medians[variant].append(forward_ms())
        finally:
            neighbors.knn, layers.knn, ptv3.knn = saved
    log(phase, t0, f'kNN tie order, whole forward (host clock, medians of 10, in turns): '
        f'{medians["tie"]} ms, with a plain torch.topk {medians["plain"]} ms')


def eval_breakdown(torch, t0, phase, cfg, weights, meta, batches: int) -> None:
    """Where the eval's time goes, per B=8 batch: host generation of the
    pairs (a fresh source, so no pair comes from its cache), the network
    forward and ICP (CUDA events; indicative)."""
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.eval.icp import refine
    from pcd_reg_hregnet_torch.eval.runner import load_model
    from pcd_reg_hregnet_torch.geometry import se3

    ds = load_dataset(cfg.data, 'test', length=cfg.data.batch_size)
    t = time.perf_counter()
    batch = next(batch_iterator(ds, cfg.data.batch_size))
    data_s = time.perf_counter() - t
    model = load_model(cfg, weights, 'cuda')
    src = torch.from_numpy(batch['uncalibed_pcd']).cuda()
    dst = torch.from_numpy(batch['pcd_left']).cuda()
    with torch.no_grad():
        out = model(src, dst)
    pose = se3.pack(out['rotation'][-1], out['translation'][-1])
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: model(src, dst), 3)
    icp_ms = cuda_ms(torch, lambda: refine(src, dst, pose, meta['icp'], meta['icp_threshold'],
                                           meta['icp_iters']), 3)
    log(phase, t0, f'per B={cfg.data.batch_size} batch (indicative): pair generation on the '
        f'host {data_s * 1e3:.0f} ms, forward {fwd_ms:.1f} ms, {meta["icp"]} ICP '
        f'{icp_ms:.1f} ms (CUDA events); x {batches} batches: {data_s * batches:.1f} s, '
        f'{fwd_ms * batches / 1e3:.1f} s, {icp_ms * batches / 1e3:.1f} s')


def eval_phase(torch, t0, smi: str, phase: str, weights, reference: str,
               max_outside: dict, summary_tol: dict | None = None,
               compute_dtype=None, pair_gate: dict | None = None) -> dict:
    """The test split through `eval.runner.evaluate` on the card, held pair
    for pair and layer for layer against the JAX package's CPU eval of the
    same checkpoint (`reference`), with at most `max_outside` pairs per
    layer outside the per-pair gate, and each layer's summary within
    `summary_tol[layer]` (rre deg, rte m, recall), by default
    `EVAL_RRE_TOL`, `EVAL_RTE_TOL`, `EVAL_RECALL_TOL`.  With
    `compute_dtype`, the checkpoint is served in that dtype (the reference
    must record the same).  `pair_gate[layer]` = (R, t m, count) adds a
    second per-pair gate: at most `count` pairs with a pose outside R / t."""
    import dataclasses

    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.eval.calib_eval import pose_deviation
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    from pcd_reg_hregnet_torch.utils import checkpoint

    with open(reference) as f:
        ref = json.load(f)
    meta = ref['reference']
    cfg = checkpoint.load_config(weights)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 compute_dtype=compute_dtype))
    if meta['batch_size'] != cfg.data.batch_size or meta['split'] != 'test' or \
            ref['model'] != cfg.model.name or \
            meta.get('compute_dtype', 'float32') != cfg.model.compute_dtype:
        raise AssertionError(f'{reference} was made at {meta} for {ref["model"]}, the '
                             f'checkpoint evaluates {cfg.model.name} on the test split at '
                             f'B={cfg.data.batch_size}')
    pairs = meta['pairs']
    ds = load_dataset(cfg.data, 'test', length=pairs)
    per_forward = per_forward_launches(cfg.model)

    # --- the main path, counted -------------------------------------------
    reset_launches()
    t_main = time.perf_counter()
    out = evaluate(cfg, weights, split='test', icp=meta['icp'],
                   icp_threshold=meta['icp_threshold'], icp_iters=meta['icp_iters'],
                   dataset=ds, device='cuda')
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_main
    launches = read_launches()
    forwards = -(-pairs // cfg.data.batch_size)
    log(phase, t0, f'evaluate(test, B={cfg.data.batch_size}, icp={meta["icp"]}, '
        f'{meta["icp_iters"]} iterations): {pairs} pairs in {eval_s:.2f} s '
        f'({pairs / eval_s:.1f} pairs/s, host clock, data generation included; '
        f'indicative only) on {smi}; launches {launches}')
    check_launches(launches, per_forward, forwards)
    eval_breakdown(torch, t0, phase, cfg, weights, meta, forwards)

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
        log(phase, t0, f'{name}: card rre_deg {rre[0]:.5f} rte_m {rte[0]:.5f} recall '
            f'{rec[0]:.4f}; JAX CPU {rre[1]:.5f} {rte[1]:.5f} {rec[1]:.4f}; '
            f'{int(bad.sum())} pairs outside the per-pair gate (at most '
            f'{max_outside[name]}) {np.flatnonzero(bad).tolist()}; max |dR| {dR.max():.2e}, '
            f'max |dt| {dt.max():.2e} m, median |dR| {np.median(dR):.2e}')
        if bad.sum() > max_outside[name]:
            failed.append(f'{name}: {int(bad.sum())} pairs outside the per-pair gate, at most '
                          f'{max_outside[name]}: {np.flatnonzero(bad).tolist()}')
        if pair_gate:
            tol_r, tol_t, most = pair_gate[name]
            wide = (dR > tol_r) | (dt > tol_t)
            log(phase, t0, f'{name}: {int(wide.sum())} pairs outside R {tol_r} / t {tol_t} m '
                f'(at most {most}) {np.flatnonzero(wide).tolist()}')
            if wide.sum() > most:
                failed.append(f'{name}: {int(wide.sum())} pairs outside R {tol_r} / t {tol_t} '
                              f'm, at most {most}')
        tol_rre, tol_rte, tol_rec = (summary_tol or {}).get(
            name, (EVAL_RRE_TOL, EVAL_RTE_TOL, EVAL_RECALL_TOL))
        if not (abs(rre[0] - rre[1]) <= tol_rre and abs(rte[0] - rte[1]) <= tol_rte
                and abs(rec[0] - rec[1]) <= tol_rec):
            failed.append(f'{name} summary: card rre {rre[0]}, rte {rte[0]}, recall {rec[0]}; '
                          f'JAX CPU {rre[1]}, {rte[1]}, {rec[1]}')
    log(phase, t0, f'{int(outside.sum())} of {pairs} pairs outside the per-pair gate '
        f'(R {POSE_TOL_R}, t {POSE_TOL_T} m) at some layer; worst: pair {worst[1]} '
        f'{worst[2]} {worst[3]}')
    if failed:
        raise AssertionError('; '.join(failed))
    stats = ('rre_deg', 'rte_m', 'rre_p95', 'rte_p95')
    REPORT[phase] = {key: out[key] for key in ('summary', 'summary_network')}
    for key in ('summary', 'summary_network'):
        log(phase, t0, f'{key}: card ' + ', '.join(f'{k} {out[key][k]:.5f}' for k in stats)
            + '; JAX CPU ' + ', '.join(f'{k} {ref[key][k]:.5f}' for k in stats))
        if compute_dtype and 'eval' in REPORT:   # what serving in bf16 costs, no gate
            log(phase, t0, f'{key}: card {compute_dtype} beside the card\'s f32 eval: '
                + ', '.join(f'{k} {out[key][k]:.5f} vs {REPORT["eval"][key][k]:.5f}'
                            for k in stats))
    return launches


FEATS_TERMS = tuple(f'{k}_l{lvl}' for k in ('chamfer', 'matching') for lvl in (1, 2, 3))


def feats_pair_losses(torch, objective, batch: dict) -> dict:
    """The feats objective at eval on one batch: each pair's
    `chamfer_l{1,2,3}` and `matching_l{1,2,3}` (the losses of that pair
    alone, as `tools/export_torch_weights.py --feats` records them) and its
    level-3 keypoints `xyz_3_src` / `xyz_3_dst`, as numpy arrays."""
    from pcd_reg_hregnet_torch.core.device import fp32_numerics
    from pcd_reg_hregnet_torch.geometry import se3
    from pcd_reg_hregnet_torch.losses import matching_loss, prob_chamfer_loss
    objective.eval()
    out = {k: [] for k in FEATS_TERMS}
    with torch.no_grad(), fp32_numerics():
        _, _, (rs, rd) = objective(batch)
        gt_R, gt_t = se3.unpack(se3.inverse(batch['igt']))
        for i in range(len(gt_t)):
            one = slice(i, i + 1)
            for lvl in (1, 2, 3):
                x, s, d = f'xyz_{lvl}', f'sigmas_{lvl}', f'desc_{lvl}'
                out[f'chamfer_l{lvl}'].append(float(prob_chamfer_loss(
                    rs[x][one], rd[x][one], rs[s][one], rd[s][one], gt_R[one], gt_t[one])))
                out[f'matching_l{lvl}'].append(float(matching_loss(
                    rs[x][one], rs[s][one], rs[d][one], rd[x][one], rd[s][one], rd[d][one],
                    gt_R[one], gt_t[one])))
    out = {k: np.asarray(v) for k, v in out.items()}
    out['xyz_3_src'] = rs['xyz_3'].cpu().numpy()
    out['xyz_3_dst'] = rd['xyz_3'].cpu().numpy()
    return out


def feats_yardstick_run(torch, device: str, pairs=None) -> tuple[dict, dict]:
    """(the port's `feats_pair_losses` of the exported descriptor checkpoint
    on the yardstick's first `pairs` test pairs, at its batch size, on
    `device`; the JAX-CPU yardstick `FEATS_REFERENCE`)."""
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.train.feats import FeatsObjective
    from pcd_reg_hregnet_torch.utils import checkpoint

    with open(FEATS_REFERENCE) as f:
        ref = json.load(f)
    pairs = pairs or ref['reference']['pairs']
    cfg, weights, _ = checkpoint.read(checkpoint.FEATS)
    if ref['reference']['batch_size'] != cfg.data.batch_size:
        raise AssertionError(f'{FEATS_REFERENCE} was made at B={ref["reference"]["batch_size"]}')
    objective = FeatsObjective(cfg, train_desc=True)
    objective.load_state_dict(weights, strict=True)
    objective.to(device)
    ds = load_dataset(cfg.data, 'test', length=pairs)
    runs = [feats_pair_losses(torch, objective, loop.to_device(b, torch.device(device)))
            for b in batch_iterator(ds, cfg.data.batch_size, drop_last=False)]
    got = {k: np.concatenate([r[k] for r in runs]) for k in runs[0]}
    return got, {k: np.asarray(v)[:pairs] for k, v in ref.items() if k != 'batches'
                 and k != 'reference'}


def feats_deviation(got: dict, ref: dict) -> tuple[np.ndarray, np.ndarray]:
    """(|got - ref| / |ref| [pairs, 6] over `FEATS_TERMS`; whether each
    pair's level-3 keypoints are the same points in both, to 1e-3 m)."""
    rel = np.stack([np.abs(got[k] - ref[k]) / np.abs(ref[k]) for k in FEATS_TERMS], 1)
    same = np.array([np.abs(got[f'xyz_3_{s}'][i] - ref[f'xyz_3_{s}'][i]).max() < 1e-3
                     for i in range(len(rel)) for s in ('src', 'dst')]).reshape(-1, 2).all(1)
    return rel, same


class PlainKernels:
    """Inside the block, the model's four kernel calls (K1, K2, K3, K3b) go to
    their plain versions on the card too: `ops.sampling`'s FPS entries and
    the PTv3 attention's autograd Function are swapped for the plain
    `fps_reference`, `patch_attention_reference` and
    `patch_attention_backward_reference`, and put back on exit.  Only this
    script does this, to hold a train step against its plain self."""

    def __init__(self, torch):
        from pcd_reg_hregnet_torch.ops.kernels import attention as kattn
        from pcd_reg_hregnet_torch.ops.kernels import fps as kfps

        class PlainAttention(torch.autograd.Function):
            @staticmethod
            def forward(ctx, qkv, scale):
                ctx.save_for_backward(qkv)
                ctx.scale = scale
                out = kattn.patch_attention_reference(*kattn.unpack_qkv(qkv), scale)
                return out.transpose(1, 2).contiguous()

            @staticmethod
            def backward(ctx, grad):
                qkv, = ctx.saved_tensors
                grads = kattn.patch_attention_backward_reference(
                    *kattn.unpack_qkv(qkv), grad.transpose(1, 2), ctx.scale)
                dqkv = torch.empty_like(qkv)
                for dst, src in zip(kattn.unpack_qkv(dqkv), grads):
                    dst.copy_(src)
                return dqkv, None

        self.swaps = {'fps': lambda xyz, m: kfps.fps_reference(xyz, None, m),
                      'wfps': lambda xyz, w, m: kfps.fps_reference(xyz, w, m),
                      'attn': PlainAttention}

    def __enter__(self):
        from pcd_reg_hregnet_torch.models import ptv3
        from pcd_reg_hregnet_torch.ops import sampling
        self.saved = (sampling.farthest_point_sample, sampling.weighted_farthest_point_sample,
                      ptv3.PatchAttentionFunction)
        sampling.farthest_point_sample = self.swaps['fps']
        sampling.weighted_farthest_point_sample = self.swaps['wfps']
        ptv3.PatchAttentionFunction = self.swaps['attn']
        return self

    def __exit__(self, *exc):
        from pcd_reg_hregnet_torch.models import ptv3
        from pcd_reg_hregnet_torch.ops import sampling
        (sampling.farthest_point_sample, sampling.weighted_farthest_point_sample,
         ptv3.PatchAttentionFunction) = self.saved


def _keypoint_hook(objective, store: dict):
    """Record each tower's keypoints of every level at the objective's
    forward (a registration objective's model outputs carry them under
    `src_feats` / `dst_feats`, a feats objective returns the two towers)."""
    def hook(module, args, out):
        ret = out[2]
        towers = ret if isinstance(ret, tuple) else (ret['src_feats'], ret['dst_feats'])
        store.clear()
        store.update({f'{side}_{lvl}': tower[f'xyz_{lvl}'].detach().clone()
                      for side, tower in zip(('src', 'dst'), towers) for lvl in (1, 2, 3)})
    return objective.register_forward_hook(hook)


def profile_window(torch, fn, reps: int):
    """(host ms, device busy ms, device ops, [(device ms, launches, kernel
    name)] largest first) per `fn()` over `reps` calls under
    torch.profiler, after the caller's warm-up."""
    from torch.profiler import ProfilerActivity, profile

    from pcd_reg_hregnet_torch.profile_serve import _device_events, _union_us
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / reps * 1e3
    dev = _device_events(prof)
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3 / reps
    per_kernel: dict = {}
    for e in dev:
        per_kernel.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    top = sorted(((sum(t) / 1e3 / reps, len(t) // reps, name) for name, t in per_kernel.items()),
                 reverse=True)
    return host_ms, busy_ms, len(dev) / reps, top


def loss_terms(cfg) -> tuple:
    """The JAX metric names of the loss terms an objective reports."""
    return ('tf_loss',) + tuple(f'{t}_loss' for t in ('chamfer', 'mi', 'circle')
                                if getattr(cfg.loss, t))


def train_phase(torch, t0, smi: str, phase: str, experiment: str, weights,
                compute_dtype=None, step_tol=(TRAIN_LOSS_TOL, TRAIN_GRAD_TOL)) -> dict:
    """A trained checkpoint's own experiment (its recorded config, in
    `compute_dtype` when given) at full width on the synthetic train split,
    from the checkpoint (the MI discriminators included): `train.loop.fit`
    for `TRAIN_STEPS` steps (counted), then per-step launches, the TF32
    flags during backward, step time, peak memory and device ops, one step
    against the plain versions of the kernels (loss and gradient within
    `step_tol`), and a checkpoint round trip; with `compute_dtype`, also a
    resume of its checkpoint as the train command takes it without
    `--compute-dtype` (the checkpoint's model config), in that dtype."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.utils import checkpoint

    cfg = checkpoint.load_config(weights)   # the experiment as the checkpoint was trained
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                 compute_dtype=compute_dtype))
    bs = cfg.data.batch_size
    per_step = per_step_launches(cfg)
    per_forward = per_forward_launches(cfg.model)
    train_ds = load_dataset(cfg.data, 'train')
    val_ds = load_dataset(cfg.data, 'val', length=TRAIN_VAL_PAIRS)
    steps_per_epoch = len(train_ds) // bs

    # --- the main path, counted -------------------------------------------
    reset_launches()
    with tempfile.TemporaryDirectory() as log_dir:
        t = time.perf_counter()
        state, val = loop.fit(cfg, log_dir=log_dir, max_steps=TRAIN_STEPS,
                              datasets=(train_ds, val_ds), init=str(weights),
                              device='cuda')
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = read_launches()
        with open(Path(log_dir) / 'metrics.jsonl') as f:
            records = [json.loads(line) for line in f]
        saved = sorted(p.name for p in (Path(log_dir) / cfg.train.ckpt_dir).iterdir())
    val_forwards = -(-TRAIN_VAL_PAIRS // bs)
    log(phase, t0, f'fit({experiment}, B={bs} x {cfg.data.pcd_min_samples} points, from '
        f'{weights.name}, {TRAIN_STEPS} steps of the {cfg.train.epochs}-epoch '
        f'OneCycle schedule, val on {TRAIN_VAL_PAIRS} pairs, compute dtype '
        f'{cfg.model.compute_dtype}) in {fit_s:.2f} s on {smi}; launches {launches}; '
        f'checkpoints {saved}')
    for k in per_step:
        want = per_step[k] * TRAIN_STEPS + per_forward[k] * val_forwards
        if launches[k] != want:
            raise AssertionError(f'{k}: {launches[k]} launches in {TRAIN_STEPS} train steps and '
                                 f'{val_forwards} val forwards, expected {want}')
    steps = [r for r in records if r['split'] == 'train']
    if [r['step'] for r in steps] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f'logged train steps {[r["step"] for r in steps]}')
    terms = loss_terms(cfg)
    for r in steps:
        if not all(np.isfinite(r[k]) for k in ('loss', 'grad_norm') + terms):
            raise AssertionError(f'step {r["step"]}: ' + ', '.join(
                f'{k} {r.get(k)}' for k in ('loss', 'grad_norm') + terms))
    log(phase, t0, 'loss per step: ' + ', '.join(f'{r["loss"]:.4f}' for r in steps))
    for k in terms:
        log(phase, t0, f'{k} per step: ' + ', '.join(f'{r[k]:.4f}' for r in steps))
    log(phase, t0, 'grad norm per step: ' + ', '.join(f'{r["grad_norm"]:.3f}' for r in steps))
    log(phase, t0, f'val after {TRAIN_STEPS} steps: loss {val["loss"]:.5f}, rre '
        f'{val["rre"]:.5f} deg, rte {val["rte"]:.5f} m; per step exactly {per_step}')
    if set(saved) != {'last', *(f'best_{m}' for m in loop.BEST_METRICS)}:
        raise AssertionError(f'checkpoints written: {saved}')

    del state   # the single steps run on states of their own
    it = batch_iterator(train_ds, bs, shuffle=True, seed=cfg.train.seed, epoch=0)
    batches = [loop.to_device(next(it), torch.device('cuda')) for _ in range(TRAIN_TIMED + 4)]
    def new_state(fresh, cfg=cfg):
        return loop.create_state(cfg, steps_per_epoch, device='cuda',
                                 init=None if fresh else weights)
    REPORT[phase] = step_checks(
        torch, t0, smi, phase, cfg, per_step, batches, new_state,
        'PatchAttention_0.Dense_0.weight' if cfg.model.backbone == 'ptv3'
        else 'desc_extractor_1.ConvBNReLU_0.Dense_0.weight', *step_tol)
    if compute_dtype is not None:
        if 'train' in REPORT:
            log(phase, t0, f'{compute_dtype} step beside the f32 train phase\'s: ' + ', '.join(
                f'{k} {v:.2f} vs {REPORT["train"][k]:.2f}' for k, v in REPORT[phase].items()))
        resume_in_dtype(torch, t0, phase, experiment, cfg, new_state, batches)
    return launches


def resume_in_dtype(torch, t0, phase: str, experiment: str, cfg, new_state, batches) -> None:
    """A train checkpoint of `cfg` resumed as `python -m
    pcd_reg_hregnet_torch.train --experiment EXPERIMENT --resume PATH`
    takes it, with no `--compute-dtype`: the config comes from the
    checkpoint, so the resumed state computes in `cfg`'s dtype, and its
    next step equals the uninterrupted state's."""
    import argparse
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.train import experiments, loop
    from pcd_reg_hregnet_torch.utils import checkpoint
    step = loop.make_train_step()
    state = new_state(False)
    step(state, batches[0])
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_train(Path(d) / 'ck', state, cfg)
        ap = argparse.ArgumentParser()
        experiments.add_config_args(ap)
        resumed = experiments.config_from_args(
            ap.parse_args(['--experiment', experiment]),
            model_base=checkpoint.load_config(Path(d) / 'ck').model)
        other = new_state(True, resumed)
        checkpoint.restore_train(Path(d) / 'ck', other)
    if resumed.model != cfg.model:
        raise AssertionError(f'resumed without --compute-dtype: {resumed.model.compute_dtype}, '
                             f'the run was {cfg.model.compute_dtype}')
    m1, m2 = step(state, batches[1]), step(other, batches[1])
    if float(m1['loss']) != float(m2['loss']):
        raise AssertionError(f'resumed step loss {float(m2["loss"])} vs {float(m1["loss"])}')
    log(phase, t0, f'checkpoint resumed without --compute-dtype: {resumed.model.compute_dtype}, '
        f'the next step equal (loss {float(m1["loss"]):.6f})')


def step_checks(torch, t0, smi: str, phase: str, cfg, per_step: dict, batches: list,
                new_state, hook_param: str, loss_tol: float = TRAIN_LOSS_TOL,
                grad_tol: float = TRAIN_GRAD_TOL) -> dict:
    """Single train steps of an objective (`new_state(fresh)` makes its state
    on the card: from the phase's weights, or seeded when `fresh`) on
    device-resident `batches` (`TRAIN_TIMED` + 4): the launches of single
    steps and TF32 off in their backward (read by a gradient hook on the
    first parameter named `*hook_param`, with the process default set to
    True); the median synced step time, peak memory and device ops
    (torch.profiler); one step with the kernels against one with the plain
    versions of all four on the same batch and weights (keypoints identical
    at every level, else the next batch; the loss within `loss_tol`
    relative, every gradient within `grad_tol` of the global norm); and a
    checkpoint round trip whose next step equals the step without it.
    Returns the median step ms, peak GiB and device ops per step."""
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.utils import checkpoint

    bs = cfg.data.batch_size
    state = new_state(False)
    step = loop.make_train_step()
    flags = []
    param = next(p for n, p in state.objective.named_parameters() if n.endswith(hook_param))
    handle = param.register_hook(lambda g: flags.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        for batch in batches[:2]:
            reset_launches()
            step(state, batch)
            got = read_launches()
            if got != per_step:
                raise AssertionError(f'launches in one train step {got}, expected {per_step}')
    finally:
        handle.remove()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    if not flags or any(f != (False, False) for f in flags):
        raise AssertionError(f'TF32 flags (matmul, cudnn) during backward: {flags}')
    log(phase, t0, f'launches per step {per_step}; TF32 off in both backward passes '
        f'(matmul, cudnn) = {flags} with the process default set to True')
    times = []
    for batch in batches[2:2 + TRAIN_TIMED]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    step(state, batches[-2])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    host_ms, busy_ms, ops, top = profile_window(torch, lambda: step(state, batches[-1]), 2)
    log(phase, t0, f'step B={bs}: median {np.median(times):.1f} ms (min {min(times):.1f}, max '
        f'{max(times):.1f}; {TRAIN_TIMED} synced steps, host clock) on {smi}; peak memory '
        f'{peak / 2**30:.2f} GiB (max_memory_allocated); profiler, 2 steps: host '
        f'{host_ms:.1f} ms/step, device busy {busy_ms:.1f} ms/step ({busy_ms / host_ms:.1%}, '
        f'idle {1 - busy_ms / host_ms:.1%}), {ops:.0f} device ops/step')
    for ms, n, name in top[:12]:
        print(f'  {ms:8.3f} ms/step {n:6d}x  {name[:100]}')
    del state

    # --- kernels against their plain versions, one step, same weights -------
    differing = 0
    for i, batch in enumerate(batches[:4]):
        runs = []
        for plain in (False, True):
            st = new_state(False)
            kps = {}
            hook = _keypoint_hook(st.objective, kps)
            if plain:
                with PlainKernels(torch):
                    m = step(st, batch)
            else:
                m = step(st, batch)
            hook.remove()
            runs.append((st, m, dict(kps), {n: p.grad.clone() for n, p in
                                            st.objective.named_parameters() if p.grad is not None}))
        (sk, mk, kk, gk), (_, mp, kp, gp) = runs
        del runs
        same = {key: bool(torch.equal(kk[key], kp[key])) for key in kk}
        if not all(same.values()):
            pairs = {key: sorted(set(torch.nonzero((kk[key] != kp[key]).any(-1))[:, 0].tolist()))
                     for key, ok in same.items() if not ok}
            differing += 1
            log(phase, t0, f'batch {i}: K2 keypoints differ from the plain version\'s at '
                f'(tower_level: pairs) {pairs}: a weighted-FPS near-tie; the next batch decides')
            if differing == 2:
                raise AssertionError('two batches in a row with keypoints that differ between '
                                     'the kernels and the plain versions')
            continue
        loss_k, loss_p = float(mk['loss']), float(mp['loss'])
        norm = float(mk['grad_norm'])
        worst = max((float((gk[n] - gp[n]).abs().max()), n) for n in gk)
        log(phase, t0, f'batch {i}: kernels vs plain versions, one step: keypoints identical '
            f'at every level of both towers; loss {loss_k:.6f} vs {loss_p:.6f} (rel '
            f'{abs(loss_k - loss_p) / abs(loss_p):.2e}); max |dgrad| {worst[0]:.3e} '
            f'({worst[1]}) = {worst[0] / norm:.2e} of the global norm {norm:.3f}')
        if set(gk) != set(gp) or not abs(loss_k - loss_p) <= loss_tol * abs(loss_p) \
                or not worst[0] <= grad_tol * norm:
            raise AssertionError(f'kernels vs plain: loss {loss_k} vs {loss_p}, max |dgrad| '
                                 f'{worst} against the global norm {norm}')
        break

    # --- checkpoint round trip ----------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_train(Path(d) / 'ck', sk, cfg)
        other = new_state(True)
        checkpoint.restore_train(Path(d) / 'ck', other)
    extra = checkpoint.objective_state(sk.objective)
    if any(not torch.equal(v, checkpoint.objective_state(other.objective)[k])
           for k, v in extra.items()) or set(other.optimizer.state) != set(sk.optimizer.state):
        raise AssertionError('the objective\'s own leaves or optimizer state differ after '
                             'a checkpoint round trip')
    m1, m2 = step(sk, batches[5]), step(other, batches[5])
    if (other.step, float(m2['loss'])) != (sk.step, float(m1['loss'])) or \
            abs(float(m1['grad_norm']) - float(m2['grad_norm'])) > 1e-4 * float(m1['grad_norm']):
        raise AssertionError(f'after a checkpoint round trip: step {other.step} vs {sk.step}, '
                             f'loss {float(m2["loss"])} vs {float(m1["loss"])}, grad norm '
                             f'{float(m2["grad_norm"])} vs {float(m1["grad_norm"])}')
    log(phase, t0, f'checkpoint round trip ({len(extra)} objective leaves beside the model\'s'
        + (f': {sorted(extra)[:2]}...' if extra else '') + f'): the next step equal (loss '
        f'{float(m1["loss"]):.6f}, step {sk.step})')
    return {'median step ms': float(np.median(times)), 'peak GiB': peak / 2**30,
            'device busy ms': busy_ms, 'device ops': ops}


def feats_config(stage: str, batch: int):
    """reg_v11 (`model_v6` at full width) with the feats recipe of `stage` at
    batch `batch`, as `python -m pcd_reg_hregnet_torch.train.feats` builds
    it."""
    import dataclasses

    from pcd_reg_hregnet_torch.train import experiments, feats
    cfg = experiments.experiment('reg_v11')
    return feats.recipe(dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=batch)), stage)


def feats_step_launches(cfg, stage: str) -> dict:
    """Each kernel's launches in one feats train step: a pair-forward (both
    towers); the attention backward only where a loss reads the
    descriptors, in the descriptor stage."""
    per = per_forward_launches(cfg.model)
    attn = per['patch_attention'] + per['patch_attention_bf16']
    return dict(per, **{_bwd_key(cfg.model): attn if stage == 'descriptor' else 0})


def module_ms(torch, modules, fn, reps: int) -> float:
    """Device-timeline ms per `fn()` between each module's forward start and
    end (CUDA events recorded by forward hooks), summed over `modules`."""
    marks: list = []

    def mark(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)
    handles = [h for m in modules for h in (m.register_forward_pre_hook(mark),
                                            m.register_forward_hook(mark))]
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])) / reps


def feats_phase(torch, t0, smi: str) -> dict:
    """The two-stage feats pretrain at full width on the synthetic train
    split through `train.feats_loop.fit_feats` (counted): the detector stage
    at B=16 from the exported descriptor checkpoint's weights, then the
    descriptor stage at B=8 from the detector stage's checkpoint, each
    `FEATS_STEPS` steps; launches exactly as `feats_step_launches`, every
    loss term finite, the detector bit-identical through the descriptor
    stage; then each stage's `step_checks`, and the detector stage's PTv3
    forward, which no loss of that stage reads, timed."""
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.train.feats import create_feats_state
    from pcd_reg_hregnet_torch.train.feats_loop import fit_feats
    from pcd_reg_hregnet_torch.utils import checkpoint
    total = {k: 0 for k in KERNELS}
    final = {}
    start = str(checkpoint.FEATS)
    with tempfile.TemporaryDirectory() as log_dir:
        for stage, bs in (('detector', FEATS_DET_BATCH), ('descriptor', BATCH)):
            phase = f'feats_{stage}'
            cfg = feats_config(stage, bs)
            per_step = feats_step_launches(cfg, stage)
            train_ds = load_dataset(cfg.data, 'train')
            steps_per_epoch = len(train_ds) // bs
            stage_dir = Path(log_dir) / stage

            # --- the main path, counted -----------------------------------
            reset_launches()
            t = time.perf_counter()
            state, _ = fit_feats(cfg, stage=stage, pretrain_detector=start, log_dir=str(stage_dir),
                                 max_steps=FEATS_STEPS, datasets=(train_ds,), device='cuda')
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t
            launches = read_launches()
            for k in total:
                total[k] += launches[k]
            log(phase, t0, f'fit_feats({stage}, B={bs} x {cfg.data.pcd_min_samples} points, '
                f'from {Path(start).name}, {FEATS_STEPS} steps) in {fit_s:.2f} s on {smi}; '
                f'launches {launches}')
            check_launches(launches, per_step, FEATS_STEPS)
            with open(stage_dir / 'metrics.jsonl') as f:
                steps = [json.loads(line) for line in f]
            if [r['step'] for r in steps] != list(range(1, FEATS_STEPS + 1)):
                raise AssertionError(f'logged steps {[r["step"] for r in steps]}')
            terms = ('loss', 'grad_norm') + tuple(
                k for k in FEATS_TERMS if stage == 'descriptor' or k.startswith('chamfer'))
            for r in steps:
                if set(r) & set(FEATS_TERMS) != set(terms) - {'loss', 'grad_norm'} or \
                        not all(np.isfinite(r[k]) for k in terms):
                    raise AssertionError(f'step {r["step"]}: {r}')
            for k in terms:
                log(phase, t0, f'{k} per step: ' + ', '.join(f'{r[k]:.4f}' for r in steps))
            log(phase, t0, f'per step exactly {per_step}')
            weights = checkpoint.read(start)[1]   # what this stage started from
            final[stage] = {n: p.detach().clone() for n, p in
                            state.objective.named_parameters()}
            if stage == 'descriptor':
                det = [n for n in final[stage] if '.detector_' in n]
                moved = [n for n in det if not torch.equal(final[stage][n],
                                                           final['detector'][n])]
                trained = [n for n in final[stage] if '.ptv3_' in n and not torch.equal(
                    final[stage][n], weights[n].cuda())]
                if moved or not det or not trained:
                    raise AssertionError(f'descriptor stage: {len(moved)} of {len(det)} detector '
                                         f'parameters moved {moved[:3]}; {len(trained)} PTv3 '
                                         'parameters trained')
                log(phase, t0, f'all {len(det)} detector parameters bit-identical to the '
                    f'detector stage\'s through {FEATS_STEPS} steps; {len(trained)} PTv3 '
                    'parameters trained')
            start = str(stage_dir / cfg.train.ckpt_dir / f'feats_{stage}')
            del state

            it = batch_iterator(train_ds, bs, shuffle=True, seed=cfg.train.seed, epoch=0)
            batches = [loop.to_device(next(it), torch.device('cuda'))
                       for _ in range(TRAIN_TIMED + 4)]

            def new_state(fresh, cfg=cfg, stage=stage, weights=weights, spe=steps_per_epoch):
                st = create_feats_state(cfg, spe, stage=stage, device='cuda')
                if not fresh:
                    checkpoint.model_of(st.objective).load_state_dict(weights, strict=True)
                return st
            step_checks(torch, t0, smi, phase, cfg, per_step, batches, new_state,
                        'PatchAttention_0.Dense_0.weight' if stage == 'descriptor'
                        else 'detector_1.ConvBNReLU_0.Dense_0.weight')
            if stage == 'detector':
                st = new_state(False)
                step = loop.make_train_step()
                fe = st.objective.feature_extraction
                encoders = [getattr(fe, f'ptv3_{i + 1}') for i in range(len(cfg.model.levels))]
                step(st, batches[0])
                enc_ms = module_ms(torch, encoders, lambda: step(st, batches[1]), 3)
                step_ms = cuda_ms(torch, lambda: step(st, batches[1]), 3)
                log(phase, t0, f'the PTv3 encoders\' forward, which no loss of this stage '
                    f'reads: {enc_ms:.1f} ms of a {step_ms:.1f} ms step ({enc_ms / step_ms:.1%}; '
                    f'CUDA events on the stream, host-bound, so close to its host time) at '
                    f'B={bs} on {smi}')
                del st
            torch.cuda.empty_cache()
    return total


def feats_losses_phase(torch, t0, smi: str) -> dict:
    """The exported descriptor checkpoint's feats objective at eval on the
    yardstick's test pairs (counted): launches exactly per forward; each
    pair's per-level losses within `FEATS_ANY_RTOL` of the JAX-CPU values,
    and within `FEATS_PAIR_RTOL` but for at most `FEATS_MAX_OUTSIDE` of the
    pairs that take JAX's level-3 keypoints; the same forward with the
    plain versions on the card picks the same keypoints, every loss within
    `TRAIN_LOSS_TOL`."""
    from pcd_reg_hregnet_torch.utils import checkpoint

    cfg = checkpoint.load_config(checkpoint.FEATS)
    reset_launches()
    t = time.perf_counter()
    got, ref = feats_yardstick_run(torch, 'cuda')
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = read_launches()
    pairs = len(got[FEATS_TERMS[0]])
    forwards = -(-pairs // cfg.data.batch_size)
    log('feats_losses', t0, f'{pairs} test pairs at B={cfg.data.batch_size} in {run_s:.2f} s on '
        f'{smi}; launches {launches}')
    check_launches(launches, per_forward_launches(cfg.model), forwards)
    rel, same = feats_deviation(got, ref)
    for j, k in enumerate(FEATS_TERMS):
        i = int(np.argmax(rel[:, j]))
        log('feats_losses', t0, f'{k}: card mean {got[k].mean():.6f}, JAX CPU '
            f'{ref[k].mean():.6f}; max rel {rel[i, j]:.2e} (pair {i}), median '
            f'{np.median(rel[:, j]):.2e}')
    outside = (rel > FEATS_PAIR_RTOL).any(1)
    log('feats_losses', t0, f'pairs outside rel {FEATS_PAIR_RTOL:g}: '
        f'{np.flatnonzero(outside).tolist()}; of them with JAX\'s level-3 keypoints '
        f'{np.flatnonzero(outside & same).tolist()} (at most {FEATS_MAX_OUTSIDE}); with other '
        f'level-3 keypoints (near-ties) {np.flatnonzero(~same).tolist()}; largest rel '
        f'{rel.max():.2e} (at most {FEATS_ANY_RTOL:g})')
    with PlainKernels(torch):
        plain, _ = feats_yardstick_run(torch, 'cuda')
    kp_plain = all(np.array_equal(got[k], plain[k]) for k in ('xyz_3_src', 'xyz_3_dst'))
    rel_plain = max(float(np.max(np.abs(got[k] - plain[k]) / np.abs(plain[k])))
                    for k in FEATS_TERMS)
    log('feats_losses', t0, f'the plain versions on the card: level-3 keypoints '
        f'{"identical" if kp_plain else "DIFFERENT"}, largest rel loss difference '
        f'{rel_plain:.2e} (at most {TRAIN_LOSS_TOL:g})')
    if (outside & same).sum() > FEATS_MAX_OUTSIDE or rel.max() > FEATS_ANY_RTOL or \
            not kp_plain or rel_plain > TRAIN_LOSS_TOL:
        raise AssertionError(f'feats losses: {int((outside & same).sum())} pairs with JAX\'s '
                             f'keypoints outside {FEATS_PAIR_RTOL}, largest rel {rel.max()}; '
                             f'plain versions: keypoints identical {kp_plain}, rel {rel_plain}')
    return launches


def warm_start_phase(torch, t0, smi: str) -> dict:
    """`train.loop.fit` of reg_v11, as the warm-started checkpoint was trained,
    with `pretrain_feats` = the exported descriptor checkpoint: before step
    1 every `feature_extraction` entry is the checkpoint's and every other
    the seeded init; then `WARM_STEPS` steps and a short validation
    (counted), launches exactly per step and per val forward, every loss
    term finite."""
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.utils import checkpoint

    cfg = checkpoint.load_config(checkpoint.WARM)
    bs = cfg.data.batch_size
    train_ds = load_dataset(cfg.data, 'train')
    val_ds = load_dataset(cfg.data, 'val', length=TRAIN_VAL_PAIRS)
    feats_sd = checkpoint.read(checkpoint.FEATS)[1]
    with tempfile.TemporaryDirectory() as log_dir:
        state, _ = loop.fit(cfg, log_dir=str(Path(log_dir) / 'before'), max_steps=0,
                            datasets=(train_ds, val_ds), pretrain_feats=str(checkpoint.FEATS),
                            device='cuda')
        seeded = loop.create_state(cfg, len(train_ds) // bs, device='cuda')
        want = seeded.objective.model.state_dict()
        got = state.objective.model.state_dict()
        fe = [k for k in got if k.startswith('feature_extraction.')]
        bad = [k for k in got if not torch.equal(
            got[k], feats_sd[k].cuda() if k in fe else want[k])]
        if bad or set(fe) != set(feats_sd):
            raise AssertionError(f'before step 1: {len(bad)} entries differ {bad[:3]}; '
                                 f'{len(fe)} feature_extraction entries against '
                                 f'{len(feats_sd)} in the checkpoint')
        log('warm_start', t0, f'before step 1: all {len(fe)} feature_extraction entries '
            f'(parameters and BatchNorm statistics) equal {checkpoint.FEATS.name}\'s, the other '
            f'{len(got) - len(fe)} the seeded init')
        del state, seeded

        # --- the main path, counted -------------------------------------------
        reset_launches()
        t = time.perf_counter()
        state, val = loop.fit(cfg, log_dir=log_dir, max_steps=WARM_STEPS,
                              datasets=(train_ds, val_ds), pretrain_feats=str(checkpoint.FEATS),
                              device='cuda')
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = read_launches()
        with open(Path(log_dir) / 'metrics.jsonl') as f:
            steps = [r for r in map(json.loads, f) if r['split'] == 'train']
    per_step, per_forward = per_step_launches(cfg), per_forward_launches(cfg.model)
    val_forwards = -(-TRAIN_VAL_PAIRS // bs)
    log('warm_start', t0, f'fit({cfg.model.name}, B={bs}, pretrain_feats='
        f'{checkpoint.FEATS.name}, {WARM_STEPS} steps, val on {TRAIN_VAL_PAIRS} pairs) in '
        f'{fit_s:.2f} s on {smi}; launches {launches}')
    for k in per_step:
        if launches[k] != per_step[k] * WARM_STEPS + per_forward[k] * val_forwards:
            raise AssertionError(f'{k}: {launches[k]} launches, expected {per_step[k]} per step '
                                 f'and {per_forward[k]} per val forward')
    if [r['step'] for r in steps] != list(range(1, WARM_STEPS + 1)) or not all(
            np.isfinite(r[k]) for r in steps for k in ('loss', 'grad_norm') + loss_terms(cfg)) \
            or not all(np.isfinite(v) for v in val.values()):
        raise AssertionError(f'warm start: steps {steps}, val {val}')
    log('warm_start', t0, 'loss per step: ' + ', '.join(f'{r["loss"]:.4f}' for r in steps)
        + f'; val rre {val["rre"]:.4f} deg, rte {val["rte"]:.4f} m; per step exactly {per_step}')
    return launches


def presets_phase(torch, t0, smi: str) -> dict:
    """Every other registration experiment at full width with seeded
    weights: one B=8 forward through `serve.register` and one train step
    each (counted), exact launches, finite poses, loss terms and gradient
    norm."""
    from pcd_reg_hregnet_torch import serve
    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.train import experiments, loop
    total = {k: 0 for k in KERNELS}
    batch = None
    step = loop.make_train_step()
    for name in PRESETS:
        cfg = experiments.experiment(name)
        if batch is None:
            ds = load_dataset(cfg.data, 'train')
            batch = loop.to_device(next(batch_iterator(ds, BATCH)), torch.device('cuda'))
        state = loop.create_state(cfg, 256, device='cuda', seed=0)
        model = state.objective.model.eval()
        per_forward, per_step = per_forward_launches(cfg.model), per_step_launches(cfg)
        # --- the main path, counted ---------------------------------------
        reset_launches()
        t = time.perf_counter()
        out = serve.register(model, batch['uncalibed_pcd'], batch['pcd_left'], device='cuda')
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        fwd = read_launches()
        t = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        launches = read_launches()
        stepped = {k: launches[k] - fwd[k] for k in launches}
        if fwd != per_forward or stepped != per_step:
            raise AssertionError(f'{name}: launches per forward {fwd} (expected {per_forward}), '
                                 f'per step {stepped} (expected {per_step})')
        for k in total:
            total[k] += launches[k]
        terms = loss_terms(cfg)
        values = {k: float(metrics[k]) for k in ('loss', 'grad_norm') + terms}
        R, tr = out['rotation'], out['translation']
        if not (torch.isfinite(R).all() and torch.isfinite(tr).all()) or \
                tuple(R.shape) != (BATCH, 3, 3) or \
                not all(np.isfinite(v) for v in values.values()) or values['grad_norm'] <= 0:
            raise AssertionError(f'{name}: pose finite {bool(torch.isfinite(R).all())}, '
                                 f'{values}')
        log('presets', t0, f'{name} ({cfg.model.name}, {cfg.model.backbone}/{cfg.model.head}, '
            f'{sum(p.numel() for p in state.objective.parameters())} parameters): B='
            f'{BATCH} forward {fwd_ms:.0f} ms, step {step_ms:.0f} ms (first '
            f'calls, host clock); launches per forward {fwd}, per step {stepped}; '
            + ', '.join(f'{k} {v:.4f}' for k, v in values.items()))
        del state, model, out, metrics
        torch.cuda.empty_cache()
    log('presets', t0, f'{len(PRESETS)} experiments on {smi}; launches {total}')
    return total


def ptv3_full_shapes(B: int, n: int = PTV3_FULL_POINTS, cfg=PTV3_FULL) -> dict:
    """[R, H, K, d] -> K3 launches of one `PTV3_FULL` forward of B clouds of
    n points (K3b launches of its backward): each encoder and decoder stage
    at its point count n / stride**stage."""
    out: dict = {}
    for chans, heads, depths in (('enc_channels', 'enc_heads', 'enc_depths'),
                                 ('dec_channels', 'dec_heads', 'dec_depths')):
        for stage, (C, H, depth) in enumerate(zip(cfg[chans], cfg[heads], cfg[depths])):
            N = n // cfg['stride'] ** stage
            K = min(cfg['patch_size'], N)
            shape = (B * N // K, H, K, C // H)
            out[shape] = out.get(shape, 0) + depth
    return out


def ptv3_clouds(b: int, n: int) -> np.ndarray:
    """The first b synthetic test scenes (left clouds), resampled to n
    points by the data layer: [b, n, 3] f32."""
    from pcd_reg_hregnet_torch.data.pipeline import resample
    from pcd_reg_hregnet_torch.data.synthetic import SyntheticPairSource
    source = SyntheticPairSource(length=256, points_per_cloud=2 * N_POINTS, seed=202)
    rng = np.random.default_rng(0)
    return np.stack([resample(source.load_pair(i)['pcd_left'], n, rng)[0] for i in range(b)])


def stage_orders(torch, xyz, cfg=PTV3_FULL) -> list:
    """Every serialization the model takes of xyz [B, N, 3]: at each stage
    the z-order its pooling follows and each of `orders`, the stage's xyz
    pooled as the model pools it (the mean of each run along the z-order)."""
    from pcd_reg_hregnet_torch.ops.serialization import serialize
    out, s = [], cfg['stride']
    for stage in range(len(cfg['enc_depths'])):
        out += [serialize(xyz, cfg['grid_size'], o)[0] for o in ('z',) + cfg['orders']]
        o = out[-1 - len(cfg['orders'])]
        B, N, _ = xyz.shape
        xyz = xyz[torch.arange(B, device=xyz.device)[:, None], o].reshape(
            B, N // s, s, 3).mean(2)
    return out


def grad_check(torch, got: dict, want: dict, what: str) -> float:
    """Each gradient leaf of `got` against `want` (name -> tensor) within
    `PTV3_GRAD_TOL` of the leaf's largest value, leaves that are zero but
    for round-off (below `PTV3_ZERO_GRAD` of the largest gradient) below
    that floor in both; returns the worst ratio of the others."""
    floor = PTV3_ZERO_GRAD * max(float(g.abs().max()) for g in want.values())
    worst, bad = 0.0, []
    for k, w in want.items():
        g = got[k].to(w.device)
        if float(w.abs().max()) < floor:
            if not float(g.abs().max()) < floor:
                bad.append(f'{k}: {float(g.abs().max()):.2e} not below the floor {floor:.2e}')
            continue
        r = float((g - w).abs().max()) / float(w.abs().max())
        worst = max(worst, r)
        if not r <= PTV3_GRAD_TOL:
            bad.append(f'{k}: {r:.2e}')
    if bad:
        raise AssertionError(f'{what}: gradient leaves outside {PTV3_GRAD_TOL}: ' + '; '.join(bad))
    return worst


def ptv3_full_phase(torch, t0, smi: str) -> dict:
    """The full PointTransformerV3 at `PTV3_FULL` (f32, seeded weights) on B=8
    clouds of `PTV3_FULL_POINTS`, features = xyz: an eval forward (launches
    K3 14, K1/K2/K3b 0), a train-mode forward + backward of mean(out ** 2)
    (K3 14, K3b 14) and an eval forward with `cpe='knn'` (K3 14), each
    counted from 0; against the plain versions (`PlainKernels`) and against
    the port's CPU on the same weights (every stage's serialization orders
    identical, the forward within `PTV3_FWD_TOL`); medians, peak memory and
    device ops per step."""
    from pcd_reg_hregnet_torch.core.device import fp32_numerics
    from pcd_reg_hregnet_torch.models import zoo

    phase = 'ptv3_full'
    model = zoo.build_ptv3(device='cuda', seed=0, **PTV3_FULL)
    per = sum(ptv3_full_shapes(BATCH).values())
    log(phase, t0, f'PointTransformerV3 {PTV3_FULL}: {sum(p.numel() for p in model.parameters())} '
        f'parameters; K3 shapes per B={BATCH} forward {ptv3_full_shapes(BATCH)}')
    xyz = torch.from_numpy(ptv3_clouds(BATCH, PTV3_FULL_POINTS)).cuda()
    expect = {k: 0 for k in KERNELS}
    total = dict(expect)

    def counted(what, fn, **launches):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = read_launches()
        if got != dict(expect, **launches):
            raise AssertionError(f'{phase} {what}: launches {got}, expected {launches}')
        for k in KERNELS:
            total[k] += got[k]
        return out

    def forward(m):
        with torch.no_grad():
            return m(xyz, xyz)

    def train_step(m):
        """Train-mode forward + backward of mean(out ** 2): (out, gradients,
        running statistics it moved); the statistics are put back, so every
        run starts from the same model."""
        saved = {k: b.clone() for k, b in m.named_buffers()}
        m.train()
        m.zero_grad(set_to_none=True)
        with fp32_numerics():
            out = m(xyz, xyz)
            torch.mean(out ** 2).backward()
        m.eval()
        with torch.no_grad():
            moved = sum(not torch.equal(saved[k], b) for k, b in m.named_buffers())
            for k, b in m.named_buffers():
                b.copy_(saved[k])
        return (out.detach(), {k: p.grad.detach().clone() for k, p in m.named_parameters()},
                moved)

    # --- the main paths, counted -----------------------------------------
    out = counted('eval forward', lambda: forward(model), patch_attention=per)
    out_c = dict(shape=tuple(out.shape), finite=bool(torch.isfinite(out).all()))
    if out_c != {'shape': (BATCH, PTV3_FULL_POINTS, PTV3_FULL['dec_channels'][0]),
                 'finite': True}:
        raise AssertionError(f'{phase}: eval output {out_c}')
    out_t, grads, moved = counted('train forward + backward', lambda: train_step(model),
                                  patch_attention=per, patch_attention_bwd=per)
    if not (torch.isfinite(out_t).all() and all(torch.isfinite(g).all()
                                                for g in grads.values())):
        raise AssertionError(f'{phase}: non-finite train output or gradient')
    knn_model = zoo.build_ptv3(device='cuda', seed=0, cpe='knn', **PTV3_FULL)
    out_k = counted('eval forward, cpe=knn', lambda: forward(knn_model), patch_attention=per)
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f'{phase}: non-finite cpe=knn output')
    log(phase, t0, f'eval forward, train forward + backward and cpe=knn forward: launches '
        f'{per} / {per} + {per} / {per} (K3 / K3 + K3b / K3), finite; the train step moved '
        f'{moved} of {len(list(model.buffers()))} running statistics')

    # --- the kernels against their plain versions, on the card ------------
    with PlainKernels(torch):
        ref = forward(model)
        ref_t, ref_grads, _ = train_step(model)
        ref_k = forward(knn_model)
    errs = {}
    for what, a, b in (('eval', out, ref), ('train', out_t, ref_t), ('knn', out_k, ref_k)):
        errs[what] = float((a - b).abs().max()) / float(b.abs().max())
        if not errs[what] <= PTV3_FWD_TOL:
            raise AssertionError(f'{phase} {what} forward: kernels vs plain max|d| / max|out| '
                                 f'{errs[what]:.2e} > {PTV3_FWD_TOL}')
    errs['grad'] = grad_check(torch, grads, ref_grads, f'{phase} kernels vs plain')
    log(phase, t0, 'kernels vs plain versions (max|d| / max|value|): eval forward '
        f'{errs["eval"]:.2e}, train forward {errs["train"]:.2e}, cpe=knn forward '
        f'{errs["knn"]:.2e} (limit {PTV3_FWD_TOL}); gradient leaves worst {errs["grad"]:.2e} '
        f'(limit {PTV3_GRAD_TOL}; leaves below {PTV3_ZERO_GRAD} of the largest held below it)')

    # --- the card against the port's CPU, same weights --------------------
    orders_gpu = [o.cpu() for o in stage_orders(torch, xyz)]
    orders_cpu = stage_orders(torch, xyz.cpu())
    same = [torch.equal(a, b) for a, b in zip(orders_gpu, orders_cpu)]
    if not all(same):
        raise AssertionError(f'{phase}: serialization orders differ card vs CPU: {same}')
    cpu_model = zoo.build_ptv3(device='cpu', seed=0, **PTV3_FULL)
    t_cpu = time.perf_counter()
    with torch.no_grad():
        out_cpu = cpu_model(xyz.cpu(), xyz.cpu())
    cpu_s = time.perf_counter() - t_cpu
    d_cpu = float((out.cpu() - out_cpu).abs().max()) / float(out_cpu.abs().max())
    if not d_cpu <= PTV3_FWD_TOL:
        raise AssertionError(f'{phase}: card vs CPU max|d| / max|out| {d_cpu:.2e} > '
                             f'{PTV3_FWD_TOL}')
    log(phase, t0, f'card vs CPU: {len(same)} serialization orders identical (z, z and '
        f'hilbert at each of {len(PTV3_FULL["enc_depths"])} stages); eval forward max|d| / '
        f'max|out| {d_cpu:.2e} (CPU forward {cpu_s:.1f} s on {torch.get_num_threads()} threads)')

    # --- times, memory, device ops ----------------------------------------
    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(PTV3_FULL_REPS):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times)), min(times), max(times)

    fwd = median_ms(lambda: forward(model))
    step = median_ms(lambda: train_step(model))
    torch.cuda.reset_peak_memory_stats()
    train_step(model)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_ms, busy_ms, ops, top = profile_window(torch, lambda: train_step(model), 3)
    f_host, f_busy, f_ops, _ = profile_window(torch, lambda: forward(model), 3)
    log(phase, t0, f'{smi}: eval forward B={BATCH} median {fwd[0]:.1f} ms (min {fwd[1]:.1f}, '
        f'max {fwd[2]:.1f}); train forward + backward median {step[0]:.1f} ms (min '
        f'{step[1]:.1f}, max {step[2]:.1f}), {PTV3_FULL_REPS} each, host clock, synced; peak '
        f'memory {peak:.2f} GiB; device ops per forward {f_ops:.0f} (busy {f_busy:.1f} ms of '
        f'{f_host:.1f}), per forward + backward {ops:.0f} (busy {busy_ms:.1f} ms of '
        f'{host_ms:.1f}); top kernels of the step: ' + ', '.join(
            f'{name[:40]} {ms:.2f} ms x{n}' for ms, n, name in top[:5]))
    return total


def _quat_wxyz(yaw: float) -> list:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _pose(rec: dict) -> np.ndarray:
    w, x, y, z = rec['rotation']
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = rec['translation']
    return T


def write_man_tree(root: str, seed: int = 0) -> None:
    """A devkit-format MAN TruckScenes tree: the relational tables of
    `v1.0-mini/`, a splits file (`MAN_SCENES` scenes a split, `MAN_SAMPLES`
    keyframes each) and two lidar sweeps a sample (`.pcd.bin` rows of x, y,
    z, intensity, 0), from sensors with a real relative pose on a moving
    ego.  Each sample's two sweeps are the two views of one synthetic scene
    (`SyntheticPairSource`, ~20-30k points each, the scenes the flagship
    was trained on) in world metres, plus 5% returns 85-120 m out that the
    range filter drops, each moved into its sensor's frame."""
    import json
    import os

    from pcd_reg_hregnet_torch.data.synthetic import SyntheticPairSource
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'v1.0-mini'))
    os.makedirs(os.path.join(root, 'sweeps'))
    cs = {'LEFT': dict(token='cs_L', rotation=_quat_wxyz(0.0), translation=[1.0, 0.8, 2.0]),
          'RIGHT': dict(token='cs_R', rotation=_quat_wxyz(np.deg2rad(10)),
                        translation=[1.0, -0.7, 2.1])}
    tables = {k: [] for k in ('scene', 'sample', 'sample_data', 'ego_pose')}
    splits = {}
    si = 0
    for split, count in MAN_SCENES.items():
        splits[split] = []
        for _ in range(count):
            name = f'scene-{si:04d}'
            splits[split].append(name)
            tables['scene'].append(dict(token=f'sc{si}', name=name,
                                        first_sample_token=f's{si}_0'))
            for k in range(MAN_SAMPLES):
                tok = f's{si}_{k}'
                pose = dict(token=f'ep{si}_{k}', rotation=_quat_wxyz(0.1 * si + 0.03 * k),
                            translation=[5.0 * si + 3.0 * k, 0.5 * si, 0.0])
                tables['ego_pose'].append(pose)
                views = SyntheticPairSource(length=1, points_per_cloud=int(
                    rng.integers(*MAN_SWEEP_POINTS)), seed=1000 + 100 * si + k).load_pair(0)
                data = {}
                for side, c in cs.items():
                    n_far = len(views[f'pcd_{side.lower()}']) // 20
                    far = np.column_stack([rng.uniform(85, 120, n_far) * rng.choice([-1, 1], n_far),
                                           rng.uniform(-30, 30, n_far), rng.uniform(0, 10, n_far)])
                    world = np.concatenate([views[f'pcd_{side.lower()}'], far])
                    T = np.linalg.inv(_pose(c)) @ np.linalg.inv(_pose(pose))
                    pts = world @ T[:3, :3].T + T[:3, 3]
                    inten = np.concatenate([views[f'intensity_{side.lower()}'], rng.random(n_far)])
                    rec = np.column_stack([pts, inten, np.zeros(len(pts))]).astype(np.float32)
                    fn = f'sweeps/{tok}_{side}.pcd.bin'
                    rec.tofile(os.path.join(root, fn))
                    data[f'LIDAR_{side}'] = f'sd_{tok}_{side}'
                    tables['sample_data'].append(dict(
                        token=f'sd_{tok}_{side}', sample_token=tok, channel=f'LIDAR_{side}',
                        calibrated_sensor_token=c['token'], ego_pose_token=pose['token'],
                        filename=fn))
                tables['sample'].append(dict(token=tok, scene_token=f'sc{si}', data=data,
                                             next=f's{si}_{k + 1}' if k + 1 < MAN_SAMPLES
                                             else ''))
            si += 1
    tables.update(calibrated_sensor=list(cs.values()), sensor=[])
    for name, rows in tables.items():
        with open(os.path.join(root, 'v1.0-mini', f'{name}.json'), 'w') as f:
            json.dump(rows, f)
    with open(os.path.join(root, 'v1.0-mini', 'splits.json'), 'w') as f:
        json.dump(splits, f)


def man_eval_phase(torch, t0, smi: str) -> dict:
    """The flagship through `python -m pcd_reg_hregnet_torch.evaluate
    --dataset man --data-path <tree> --split test --icp point_to_plane`
    (its `main`, in this process, so that the launches count) on a tree
    `write_man_tree` writes to a temporary directory: launches exactly K1 2,
    K2 4, K3 36 a forward, a finite summary, and the twist table the eval
    drew written under the tree, equal to the port's draw for the split and
    to the decalibrations the results record."""
    import contextlib
    import io
    import json
    import os
    import tempfile

    from pcd_reg_hregnet_torch import evaluate as evaluate_cli
    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.data.pipeline import draw_twist_table, twists_to_igts
    from pcd_reg_hregnet_torch.geometry import rotations
    from pcd_reg_hregnet_torch.utils import checkpoint

    phase = 'man_eval'
    cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
    with tempfile.TemporaryDirectory() as root:
        t_w = time.perf_counter()
        write_man_tree(root)
        data = dataclasses.replace(cfg.data, dataset='man', path=root)
        ds = load_dataset(data, 'test')
        pair = ds.source.load_pair(0)
        sizes = [len(pair['pcd_left']), len(pair['pcd_right'])]
        log(phase, t0, f'TruckScenes tree written in {time.perf_counter() - t_w:.1f} s: '
            f'{sum(MAN_SCENES.values())} scenes x {MAN_SAMPLES} samples, {len(ds)} test pairs, '
            f'pair 0 sweeps {sizes} points (resampled to {data.pcd_min_samples})')
        results = os.path.join(root, 'results.json')
        argv = ['--dataset', 'man', '--data-path', root, '--split', 'test', '--icp',
                'point_to_plane', '--results', results]
        reset_launches()
        t = time.perf_counter()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = evaluate_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = read_launches()
        line = stdout.getvalue().strip().splitlines()[-1]
        print(f'  evaluate {" ".join(argv[:5])} ...: {line}')
        if rc != 0:
            raise AssertionError(f'{phase}: evaluate returned {rc}')
        forwards = -(-len(ds) // cfg.data.batch_size)
        check_launches(launches, per_forward_launches(cfg.model), forwards)
        with open(results) as f:
            res = json.load(f)
        summary = res['summary']
        if not all(np.isfinite(v) for v in summary.values()):
            raise AssertionError(f'{phase}: non-finite summary {summary}')
        table_path = os.path.join(root, 'perturbations_file_test.txt')
        table = np.loadtxt(table_path, dtype=np.float32, delimiter=',').reshape(-1, 6)
        drawn = draw_twist_table(data, 'test', len(ds))
        if not np.array_equal(table, drawn):
            raise AssertionError(f'{phase}: {table_path} differs from the port\'s draw')
        # the decalibrations the eval used: gt = pred^-1 @ error, each from
        # the results' (Euler xyz deg, t) of its last layer
        layer = res['layer_3']

        def pack(rows):
            a = torch.tensor(rows, dtype=torch.float64)
            T = torch.eye(4, dtype=torch.float64).repeat(len(a), 1, 1)
            T[:, :3, :3] = rotations.euler_xyz_to_matrix(torch.deg2rad(a[:, :3]))
            T[:, :3, 3] = a[:, 3:]
            return T
        used = torch.linalg.inv(pack(layer['pred_calib'])) @ pack(layer['error_calib'])
        d_igt = float((used - torch.from_numpy(twists_to_igts(table)).double()).abs().max())
        if not d_igt <= 1e-4:
            raise AssertionError(f'{phase}: decalibrations of the results differ from the '
                                 f'written table by {d_igt:.2e}')
    log(phase, t0, f'{smi}: {len(res["layer_0"]["rre"])} pairs in {seconds:.1f} s '
        f'(host clock); launches {launches} over {forwards} forwards; layer 3 (ICP) rre '
        f'{summary["rre_deg"]:.4f} deg, rte {summary["rte_m"]:.4f} m, recall '
        f'{layer["recall"]:.4f} (synthetic scans: the path runs, not its accuracy); '
        f'twist table written, equal to the port\'s draw (seed 2) and to the results\' '
        f'decalibrations (max|d| {d_igt:.1e})')
    return launches


@contextlib.contextmanager
def nccl_group():
    """A one-rank NCCL process group on the card for the enclosed block
    (`parallel.distributed.initialize` on a free localhost port)."""
    import socket

    from pcd_reg_hregnet_torch.parallel import distributed
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    distributed.initialize(f'127.0.0.1:{port}', 1, 0, device='cuda')
    try:
        yield
    finally:
        distributed.shutdown()


def slam_sequence(torch, scale: float, seed: int):
    """`SLAM_KEYFRAMES` keyframes of one synthetic world scene (`N_POINTS`
    points), keyframe k seen from pose X_k (a chain of the port's numpy
    twist draw at `scale` times the training bounds) with its own 1 cm
    noise; the edges: the odometry chain and the `SLAM_LOOPS` pairs 2-4
    apart whose relative rotation is smallest.  Returns clouds [K, N, 3],
    ground-truth poses [K, 4, 4] (CPU) and the edges."""
    from pcd_reg_hregnet_torch.core.config import DataConfig
    from pcd_reg_hregnet_torch.data.synthetic import SyntheticPairSource
    from pcd_reg_hregnet_torch.geometry import se3, so3
    from pcd_reg_hregnet_torch.geometry.perturbations import sample_twist
    K, d = SLAM_KEYFRAMES, DataConfig()
    rng = np.random.default_rng(seed)
    scene = torch.from_numpy(SyntheticPairSource(1, N_POINTS)._scene_points(rng, N_POINTS))
    tw = sample_twist(rng, d.max_rot_error * scale, d.max_trans_error * scale, d.distribution,
                      d.mag_randomly, shape=(K - 1,))
    gt = [torch.eye(4)]
    for k in range(K - 1):
        gt.append(gt[-1] @ se3.exp(tw[k]))
    gt = torch.stack(gt)
    clouds = torch.stack([se3.transform(se3.inverse(gt[k]), scene) for k in range(K)])
    clouds = clouds + torch.from_numpy(rng.normal(0, 0.01, clouds.shape).astype(np.float32))
    pairs = [(i, j) for i in range(K) for j in range(i + 2, min(i + 5, K))]
    angle = {(i, j): float(so3.geodesic_distance((se3.inverse(gt[i]) @ gt[j])[:3, :3],
                                                 torch.eye(3))) for i, j in pairs}
    loops = sorted(pairs, key=angle.get)[:SLAM_LOOPS]
    return clouds, gt, [(k, k + 1) for k in range(K - 1)] + loops


def edge_error(torch, T, ref) -> tuple:
    """Rotation (deg) and translation (m) errors of transforms `T` against
    `ref` [n, 4, 4], as numpy arrays."""
    from pcd_reg_hregnet_torch.geometry import se3, so3
    err = se3.inverse(T) @ ref
    ang = torch.rad2deg(so3.geodesic_distance(err[:, :3, :3], torch.eye(3).expand(len(T), 3, 3)))
    return ang.numpy(), err[:, :3, 3].norm(dim=-1).numpy()


def trajectory_error(torch, poses, gt) -> tuple:
    """Largest rotation (deg) and translation (m) error of `poses` against
    `gt`, both anchored at pose 0."""
    rot, tr = edge_error(torch, poses.cpu(), gt)
    return float(rot.max()), float(tr.max())


def slam_phase(torch, t0, smi: str) -> dict:
    """Pose-graph SLAM with the trained flagship registering keyframes:
    `slam_sequence` at the training bounds (18 edges) registered by
    `slam.model_register_fn` (`serve.register`, B<=8: 3 forwards, launches
    exactly 2/4/36 each), then `optimize` on the card (chi2 falls; the
    poses within `SLAM_SOLVE_TOL` of the port's CPU solve of the same
    measurements), `distributed_optimize` and `schur_optimize` (one
    partition) on a one-rank NCCL group within `SLAM_SOLVE_TOL` of the dense
    solve, and the trajectory's errors printed (no gate but finite); then
    the sequence at `SLAM_ICP_SCALE` of the bounds (ICP from the identity
    converges only within a few degrees) registered by
    `slam.icp_register_fn('point_to_plane')` recovers its ground truth
    within `SLAM_ICP_TOL` after `optimize`."""
    from pcd_reg_hregnet_torch import slam
    from pcd_reg_hregnet_torch.geometry import se3
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.utils.checkpoint import FLAGSHIP

    phase = 'slam'
    model = zoo.build('model_v6', device='cuda', weights=FLAGSHIP)
    per_forward = per_forward_launches(model.cfg)
    clouds, gt, edges = slam_sequence(torch, 1.0, 20)
    clouds = clouds.cuda()
    register = slam.model_register_fn(model)
    reset_launches()
    t = time.perf_counter()
    graph = slam.build_pose_graph(clouds, edges, register)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t
    launches = read_launches()
    forwards = -(-len(edges) // slam.sequence.MAX_BATCH)
    check_launches(launches, per_forward, forwards)
    if not all(torch.isfinite(x).all() for x in (graph.measurements, graph.weights, graph.poses)):
        raise AssertionError(f'{phase}: non-finite measurements, weights or poses')
    rel = torch.stack([se3.inverse(gt[i]) @ gt[j] for i, j in edges])
    e_rot, e_tr = edge_error(torch, graph.measurements.cpu(), rel)
    log(phase, t0, f'{len(clouds)} keyframes x {clouds.shape[1]} points, {len(edges)} edges '
        f'(loops {edges[-SLAM_LOOPS:]}) registered by the flagship in {forwards} forwards, '
        f'{reg_s:.2f} s; launches {launches}; edge weights {graph.weights.min():.2e}-'
        f'{graph.weights.max():.2e}; measurement error against the true relative poses: '
        f'median {np.median(e_rot):.3f} deg / {np.median(e_tr):.3f} m, max '
        f'{e_rot.max():.3f} deg / {e_tr.max():.3f} m')

    t = time.perf_counter()
    poses = slam.optimize(graph, iters=SLAM_ITERS)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t
    before, after = float(slam.chi2(graph.poses, graph)), float(slam.chi2(poses, graph))
    cpu = slam.optimize(slam.PoseGraph(*(a.cpu() for a in graph)), iters=SLAM_ITERS)
    d_cpu = float((poses.cpu() - cpu).abs().max())
    with nccl_group():
        sharded = slam.distributed_optimize(graph, iters=SLAM_ITERS)
        schur = slam.schur_optimize(slam.partition_graph(graph, 1), iters=SLAM_ITERS)
    d_sharded = float((sharded - poses).abs().max())
    d_schur = float((schur - poses).abs().max())
    if not (after < before and d_cpu <= SLAM_SOLVE_TOL and d_sharded <= SLAM_SOLVE_TOL
            and d_schur <= SLAM_SOLVE_TOL):
        raise AssertionError(f'{phase}: chi2 {before} -> {after}; card vs CPU {d_cpu}, '
                             f'sharded {d_sharded}, Schur {d_schur} (limit {SLAM_SOLVE_TOL})')
    rot0, tr0 = trajectory_error(torch, graph.poses, gt)
    rot, tr = trajectory_error(torch, poses, gt)
    if not all(np.isfinite(x) for x in (rot, tr)):
        raise AssertionError(f'{phase}: non-finite trajectory error {rot} deg, {tr} m')
    log(phase, t0, f'optimize on the card ({SLAM_ITERS} iterations, {opt_s * 1e3:.1f} ms): chi2 '
        f'{before:.4e} -> {after:.4e}; max|d pose| vs the CPU solve {d_cpu:.2e}, '
        f'distributed_optimize (one-rank NCCL group) {d_sharded:.2e}, schur_optimize (one '
        f'partition) {d_schur:.2e} (limit {SLAM_SOLVE_TOL}); model trajectory max error '
        f'chained {rot0:.3f} deg / {tr0:.3f} m, optimised {rot:.3f} deg / {tr:.3f} m')

    clouds, gt, edges = slam_sequence(torch, SLAM_ICP_SCALE, 21)
    t = time.perf_counter()
    graph = slam.build_pose_graph(clouds.cuda(), edges, slam.icp_register_fn('point_to_plane'))
    rot, tr = trajectory_error(torch, slam.optimize(graph, iters=SLAM_ITERS), gt)
    icp_s = time.perf_counter() - t
    if not (rot <= SLAM_ICP_TOL[0] and tr <= SLAM_ICP_TOL[1]):
        raise AssertionError(f'{phase}: ICP trajectory error {rot} deg, {tr} m (limits '
                             f'{SLAM_ICP_TOL})')
    log(phase, t0, f'ICP sequence ({SLAM_ICP_SCALE} of the training bounds, {len(edges)} '
        f'edges, point-to-plane from the identity) in {icp_s:.2f} s: max error {rot:.4f} deg '
        f'/ {tr:.4f} m after optimize (limits {SLAM_ICP_TOL[0]} deg / {SLAM_ICP_TOL[1]} m)')
    return launches


def dp_train_phase(torch, t0, smi: str) -> dict:
    """`reg_v11` from the flagship on a one-rank NCCL group: `fit` for
    `DP_STEPS` steps at B=8 (launches exactly 2/4/36/36 a step plus the
    validation's forwards, `metrics.csv` written); one step on the group
    against the same step without it: the gradient all-reduce returns the
    backward's gradients bit for bit, and the loss, every gradient and the
    BatchNorm statistics equal the step alone's (bit for bit where two
    steps alone are; else within 4x their own spread, which the
    backward's atomic scatter-adds set); the median of `DP_TIMED` synced
    steps beside the train phase's."""
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch.data import batch_iterator, load_dataset
    from pcd_reg_hregnet_torch.train import loop
    from pcd_reg_hregnet_torch.utils import checkpoint

    phase = 'dp_train'
    cfg = checkpoint.load_config(checkpoint.FLAGSHIP)
    bs = cfg.data.batch_size
    per_step, per_forward = per_step_launches(cfg), per_forward_launches(cfg.model)
    train_ds = load_dataset(cfg.data, 'train')
    val_ds = load_dataset(cfg.data, 'val', length=TRAIN_VAL_PAIRS)
    it = batch_iterator(train_ds, bs, shuffle=True, seed=cfg.train.seed, epoch=0)
    batches = [loop.to_device(next(it), torch.device('cuda')) for _ in range(DP_TIMED + 1)]
    step = loop.make_train_step()

    def one_step():
        """(loss, gradients, BatchNorm statistics) of one step from the flagship."""
        state = loop.create_state(cfg, len(train_ds) // bs, device='cuda',
                                  init=checkpoint.FLAGSHIP)
        m = step(state, batches[0])
        obj = state.objective
        return {'loss': m['loss'].reshape(1),
                **{n: p.grad.clone() for n, p in obj.named_parameters() if p.grad is not None},
                **{k: v.clone() for k, v in obj.state_dict().items() if 'running_' in k}}

    def worst(a, b):
        if a.keys() != b.keys():
            raise AssertionError(f'{phase}: leaves differ: {sorted(a.keys() ^ b.keys())[:4]}')
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    alone, again = one_step(), one_step()
    spread = worst(alone, again)
    reduced = []
    average = loop._average_over_ranks

    def recorded(tensors):
        before = [t.clone() for t in tensors]
        average(tensors)
        reduced.append(all(torch.equal(a, b) for a, b in zip(before, tensors)))
    with nccl_group(), tempfile.TemporaryDirectory() as log_dir:
        reset_launches()
        t = time.perf_counter()
        state, val = loop.fit(cfg, log_dir=log_dir, max_steps=DP_STEPS,
                              datasets=(train_ds, val_ds), init=str(checkpoint.FLAGSHIP),
                              device='cuda')
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches, fit_step = read_launches(), state.step
        rows = (Path(log_dir) / 'metrics.csv').read_text().splitlines()
        loop._average_over_ranks = recorded
        try:
            grouped = one_step()
        finally:
            loop._average_over_ranks = average
        times = []
        for batch in batches[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    val_forwards = -(-TRAIN_VAL_PAIRS // bs)
    for k in per_step:
        want = per_step[k] * DP_STEPS + per_forward[k] * val_forwards
        if launches[k] != want:
            raise AssertionError(f'{k}: {launches[k]} launches in {DP_STEPS} steps and '
                                 f'{val_forwards} val forwards, expected {want}')
    if fit_step != DP_STEPS or len(rows) != 2 or not np.isfinite(val['loss']):
        raise AssertionError(f'{phase}: step {fit_step}, metrics.csv {rows}, val {val}')
    log(phase, t0, f'fit(reg_v11, B={bs}, from the flagship, {DP_STEPS} steps) on a one-rank '
        f'NCCL group in {fit_s:.2f} s on {smi}; launches {launches} (per step exactly '
        f'{per_step}); metrics.csv header {rows[0][:60]}...; val loss {val["loss"]:.5f}')
    d_group = worst(alone, grouped)
    if reduced != [True, True] or not d_group <= 4 * spread:
        raise AssertionError(f'{phase}: all-reduces exact {reduced}; the step on the group '
                             f'differs from the step alone by {d_group} (two steps alone: '
                             f'{spread})')
    med = float(np.median(times))
    REPORT[phase] = {'median step ms': med}
    log(phase, t0, f'one step on the group: the gradient all-reduce returned the backward\'s '
        f'gradients bit for bit; against the step alone max|d| {d_group:.2e} over the loss, '
        f'{sum(1 for k in alone if "running_" not in k) - 1} gradients and '
        f'{sum(1 for k in alone if "running_" in k)} BatchNorm statistics (two steps alone: '
        f'{spread:.2e}' + ('; bit-identical' if d_group == 0 else '') + f'); step median '
        f'{med:.1f} ms (min {min(times):.1f}, max {max(times):.1f}; {DP_TIMED} synced steps, '
        f'host clock) beside the train phase\'s '
        f'{REPORT.get("train", {}).get("median step ms", float("nan")):.1f} ms')
    return launches


def seq_eval_phase(torch, t0, smi: str) -> dict:
    """The flagship with `seq_axis` on a one-rank NCCL group
    (`parallel/sequence.py`): under `sequence_mesh`, one B=8
    `serve.register` (counted: exactly 2/4/36) whose poses must be within
    `SEQ_TOL` of the unsharded model's on the same batch, the rows K3 sees
    per call, and both forwards' medians; then `evaluate(seq_parallel=1)`
    of the synthetic test split with point-to-plane ICP (counted) whose
    summaries must be within `SEQ_TOL` of the eval phase's.  Says whether
    each comparison was bit-identical."""
    from pcd_reg_hregnet_torch import serve
    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.eval.runner import evaluate
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.models.ptv3 import PatchAttention
    from pcd_reg_hregnet_torch.parallel import sequence
    from pcd_reg_hregnet_torch.utils import checkpoint

    phase = 'seq_eval'
    weights = checkpoint.FLAGSHIP
    with open(EVAL_REFERENCE) as f:
        meta = json.load(f)['reference']
    cfg = checkpoint.load_config(weights)
    per_forward = per_forward_launches(cfg.model)
    plain = zoo.build('model_v6', device='cuda', weights=weights)
    sharded = zoo.build('model_v6', device='cuda', weights=weights, seq_axis='seq')
    rng = np.random.default_rng(7)
    batch = [make_clouds(rng, N_POINTS) for _ in range(BATCH)]
    src8 = torch.from_numpy(np.stack([s for s, _ in batch])).cuda()
    dst8 = torch.from_numpy(np.stack([d for _, d in batch])).cuda()
    want = serve.register(plain, src8, dst8, device='cuda')
    rows = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: rows.append(args[0].shape[0] * args[0].shape[1]
                                    // min(m.patch_size, args[0].shape[1])))
        for m in sharded.modules() if isinstance(m, PatchAttention)]

    def timed(model):
        times = []
        for _ in range(SEQ_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            serve.register(model, src8, dst8, device='cuda')
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    ds = load_dataset(cfg.data, 'test', length=meta['pairs'])
    with nccl_group():
        group = sequence.sequence_group(1)
        with sequence.sequence_mesh(group):
            # --- the main path, counted: one B=8 forward ----------------------
            reset_launches()
            got = serve.register(sharded, src8, dst8, device='cuda')
            torch.cuda.synchronize()
            launches = read_launches()
            check_launches(launches, per_forward, 1)
            for h in hooks:
                h.remove()
            ms = {'sharded': timed(sharded)}
        ms['unsharded'] = timed(plain)
        d_pose = max(float((got[k] - want[k]).abs().max()) for k in ('rotation', 'translation'))
        same = all(torch.equal(got[k], want[k]) for k in ('rotation', 'translation'))
        log(phase, t0, f'register(B={BATCH}) on a one-rank NCCL group with seq_axis: launches '
            f'{launches} (exactly {per_forward} a forward); K3 rows a call per level '
            f'{sorted(set(rows), reverse=True)} (R = B x N / K, N / 1 rank; {len(rows)} calls); '
            f'poses against the unsharded forward max|d| {d_pose:.2e} '
            + ('(bit-identical)' if same else f'(limit {SEQ_TOL})')
            + f'; median {ms["sharded"]:.1f} ms sharded, {ms["unsharded"]:.1f} ms unsharded '
            f'({SEQ_TIMED} forwards each, host clock, indicative) on {smi}')
        if not d_pose <= SEQ_TOL:
            raise AssertionError(f'{phase}: poses differ from the unsharded forward by {d_pose}')
        # --- the main path, counted: the eval ---------------------------------
        reset_launches()
        t = time.perf_counter()
        out = evaluate(cfg, weights, split='test', icp=meta['icp'],
                       icp_threshold=meta['icp_threshold'], icp_iters=meta['icp_iters'],
                       dataset=ds, seq_parallel=1, device='cuda')
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        eval_launches = read_launches()
    forwards = -(-meta['pairs'] // cfg.data.batch_size)
    check_launches(eval_launches, per_forward, forwards)
    diffs = {key: max(abs(out[key][k] - REPORT['eval'][key][k]) for k in out[key])
             for key in ('summary', 'summary_network')}
    identical = all(out[key] == REPORT['eval'][key] for key in diffs)
    log(phase, t0, f'evaluate(seq_parallel=1, icp={meta["icp"]}): {meta["pairs"]} pairs in '
        f'{eval_s:.2f} s (host clock); launches {eval_launches} over {forwards} forwards; '
        f'summary / summary_network against those of the eval phase, max|d| '
        f'{diffs["summary"]:.2e} / {diffs["summary_network"]:.2e} '
        + ('(identical)' if identical else f'(limit {SEQ_TOL})')
        + f'; rre_deg {out["summary"]["rre_deg"]:.5f}, rte_m {out["summary"]["rte_m"]:.5f}')
    if not max(diffs.values()) <= SEQ_TOL:
        raise AssertionError(f'{phase}: summaries differ from those of the eval phase by {diffs}')
    return {k: launches[k] + eval_launches[k] for k in launches}


def run_cli(torch, t0, phase: str, argv: list) -> tuple:
    """`python -m pcd_reg_hregnet_torch ARGV` as `cli.main(ARGV)` in this
    process, the launch counts set to 0 just before it: (its stdout, the
    launches it made)."""
    import io

    from pcd_reg_hregnet_torch import cli
    out = io.StringIO()
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f'{phase}: {argv[0]} returned {rc}:\n{out.getvalue()[-3000:]}')
    log(phase, t0, f'python -m pcd_reg_hregnet_torch {" ".join(argv)}: '
        f'{time.perf_counter() - t:.1f} s; launches {launches}')
    return out.getvalue(), launches


def cli_phase(torch, t0, smi: str) -> dict:
    """`python -m pcd_reg_hregnet_torch` through `cli.main` on the card,
    each command's launches counted: `infer --icp point_to_plane` on two
    synthetic test pairs (one `.npy` pair, one `.bin` pair) launches
    exactly 2/4/36 (one forward) and writes the pose JSON of
    `serve.infer_pair` on the same clouds, bit for bit; `eval --icp-only`
    on the synthetic test split launches no kernel and gives a finite
    summary; `train --experiment reg_v11 --max-steps 2 --lr 1e-4` launches
    exactly 2/4/36/36 a step plus 2/4/36 a validation forward and writes
    checkpoints whose meta records the options.  Returns the launches of
    `infer` and `train`."""
    import tempfile
    from pathlib import Path

    from pcd_reg_hregnet_torch import cli, serve
    from pcd_reg_hregnet_torch.data import load_dataset
    from pcd_reg_hregnet_torch.models import zoo
    from pcd_reg_hregnet_torch.train.experiments import config_from_args
    from pcd_reg_hregnet_torch.utils.checkpoint import FLAGSHIP

    phase = 'cli'
    model = zoo.build('model_v6', device='cuda', weights=FLAGSHIP)
    per_forward = per_forward_launches(model.cfg)
    total = dict.fromkeys(per_forward, 0)
    with tempfile.TemporaryDirectory() as d:
        for i, (src, dst) in enumerate(synthetic_pairs(2)):
            if i == 0:
                paths = [f'{d}/src{i}.npy', f'{d}/dst{i}.npy']
                np.save(paths[0], src)
                np.save(paths[1], dst)
            else:
                paths = [f'{d}/src{i}.bin', f'{d}/dst{i}.bin']
                for path, pts in zip(paths, (src, dst)):
                    np.column_stack([pts[:, :3], np.zeros((len(pts), 2))]).astype(
                        np.float32).tofile(path)
            out = f'{d}/pose{i}.json'
            _, launches = run_cli(torch, t0, phase, [
                'infer', '--ckpt', str(FLAGSHIP), '--src', paths[0], '--dst', paths[1],
                '--icp', 'point_to_plane', '--out', out])
            check_launches(launches, per_forward, 1)
            total = {k: total[k] + launches[k] for k in total}
            got = json.loads(Path(out).read_text())
            want = json.loads(json.dumps(serve.infer_pair(
                model, src[:, :3], dst[:, :3], device='cuda', icp='point_to_plane')))
            if got != want:
                diff = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
                           for k in want) if set(got) == set(want) else None
                raise AssertionError(f'{phase}: infer pair {i} differs from serve.infer_pair '
                                     f'(keys {sorted(got)} vs {sorted(want)}, max|d| {diff})')
        log(phase, t0, 'infer (point-to-plane ICP) on 2 synthetic test pairs (.npy, .bin): '
            'the pose JSON of serve.infer_pair, bit-identical; launches exactly '
            f'{per_forward} each')
        results = f'{d}/icp_only.json'
        _, launches = run_cli(torch, t0, phase, [
            'eval', '--icp-only', '--icp', 'point_to_plane', '--batch-size', '8',
            '--icp-iters', '30', '--results', results])
        check_launches(launches, per_forward, 0)
        res = json.loads(Path(results).read_text())
        summary = res['summary']
        if len(res['layer_0']['rre']) != 256 or not all(np.isfinite(v)
                                                        for v in summary.values()):
            raise AssertionError(f'{phase}: eval --icp-only: {len(res["layer_0"]["rre"])} '
                                 f'pairs, summary {summary}')
        log(phase, t0, f'eval --icp-only (point-to-plane from the identity, 30 iterations) '
            f'on the 256 synthetic test pairs, no kernel launched: summary {summary}')
        run_dir = f'{d}/run'
        argv = ['train', '--experiment', 'reg_v11', '--max-steps', '2', '--lr', '1e-4',
                '--batch-size', '8', '--log-dir', run_dir]
        cfg = config_from_args(cli.parser().parse_args(argv))
        per_step, bs = per_step_launches(cfg), cfg.data.batch_size
        val_forwards = -(-len(load_dataset(cfg.data, 'val')) // bs) \
            if cfg.train.val_every == 1 else 0
        _, launches = run_cli(torch, t0, phase, argv)
        for k in per_step:
            want = per_step[k] * 2 + per_forward[k] * val_forwards
            if launches[k] != want:
                raise AssertionError(f'{phase}: {k}: {launches[k]} launches in 2 steps and '
                                     f'{val_forwards} val forwards, expected {want}')
        total = {k: total[k] + launches[k] for k in total}
        meta = json.loads(Path(run_dir, 'ckpt', 'last', 'meta.json').read_text())
        saved = json.loads(meta['config'])
        csv_rows = Path(run_dir, 'metrics.csv').read_text().splitlines()
        if (meta['step'], saved['train']['lr'], saved['data']['batch_size']) != (2, 1e-4, 8) \
                or len(csv_rows) != 2:
            raise AssertionError(f'{phase}: train meta step {meta["step"]}, lr '
                                 f'{saved["train"]["lr"]}, batch {saved["data"]["batch_size"]}'
                                 f'; metrics.csv {csv_rows}')
        log(phase, t0, f'train --experiment reg_v11 --max-steps 2 --lr 1e-4 --batch-size 8: '
            f'launches exactly {per_step} a step and {per_forward} in each of {val_forwards} '
            f'val forwards; checkpoint meta step 2, lr 1e-4, batch 8; metrics.csv '
            f'{csv_rows[0][:50]}...')
    return total


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
        entries += check_attention(torch, lib, kattn, gen, t0)
        entries.append(check_attention_backward(torch, lib, kattn, gen, t0))
        entries.append(check_attention_backward(torch, lib, kattn, gen, t0, torch.bfloat16))

    from pcd_reg_hregnet_torch.utils.checkpoint import A1, FLAGSHIP, NONE, WARM
    counted = [serve_phase(torch, t0, 'serve', 'model_v6', FLAGSHIP),
               eval_phase(torch, t0, smi, 'eval', FLAGSHIP, EVAL_REFERENCE, EVAL_MAX_OUTSIDE),
               train_phase(torch, t0, smi, 'train', 'reg_v11', FLAGSHIP),
               serve_phase(torch, t0, 'bf16_serve', 'model_v6', FLAGSHIP, 'bfloat16',
                           BF16_POSE_TOL),
               eval_phase(torch, t0, smi, 'bf16_eval', FLAGSHIP, BF16_EVAL_REFERENCE,
                          BF16_EVAL_MAX_OUTSIDE, BF16_EVAL_SUMMARY_TOL, 'bfloat16',
                          BF16_EVAL_PAIR_GATE),
               train_phase(torch, t0, smi, 'bf16_train', 'reg_v11', FLAGSHIP, 'bfloat16',
                           BF16_TRAIN_TOL),
               serve_phase(torch, t0, 'a1_serve', 'model_v2', A1),
               eval_phase(torch, t0, smi, 'a1_eval', A1, A1_EVAL_REFERENCE,
                          A1_EVAL_MAX_OUTSIDE),
               train_phase(torch, t0, smi, 'a1_train', 'reg_v6', A1),
               presets_phase(torch, t0, smi),
               feats_phase(torch, t0, smi),
               feats_losses_phase(torch, t0, smi),
               eval_phase(torch, t0, smi, 'warm_eval', WARM, WARM_EVAL_REFERENCE,
                          WARM_EVAL_MAX_OUTSIDE, WARM_EVAL_SUMMARY_TOL),
               warm_start_phase(torch, t0, smi),
               ptv3_full_phase(torch, t0, smi),
               man_eval_phase(torch, t0, smi),
               slam_phase(torch, t0, smi),
               dp_train_phase(torch, t0, smi),
               cli_phase(torch, t0, smi),
               seq_eval_phase(torch, t0, smi),
               eval_phase(torch, t0, smi, 'none_eval', NONE, NONE_EVAL_REFERENCE,
                          NONE_EVAL_MAX_OUTSIDE, NONE_EVAL_SUMMARY_TOL)]
    for e in entries:
        e['launches'] = sum(c[e['name']] for c in counted)
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
