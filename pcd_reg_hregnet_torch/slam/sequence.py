"""Sequence-level registration: clouds -> pairwise poses -> pose graph
(port of `pcd_reg_hregnet_tpu/slam/sequence.py`).

Given a keyframe stream and an edge list (odometry links and loop
closures), register every edge's pair, chain the odometry edges into
initial world poses, and hand a `PoseGraph` to `optimize` /
`distributed_optimize` / `schur_optimize`.  An edge (i, j) stores
Z_ij = X_i^{-1} X_j: the transform that registers cloud j (source) onto
cloud i (destination).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core.device import fp32_numerics
from ..eval.icp import refine
from ..geometry import se3
from ..serve import register as serve_register
from .pose_graph import PoseGraph

RegisterFn = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# (src [E, N, 3], dst [E, N, 3]) -> (T [E, 4, 4] aligning src into dst's frame,
#                                    confidence weights [E])

MAX_BATCH = 8   # edges per forward of `model_register_fn`


def model_register_fn(model: torch.nn.Module) -> RegisterFn:
    """A registration model as the edge registrar: `serve.register` over the
    edges in batches of at most `MAX_BATCH`, on the model's device.  The finest
    level's pose is the measurement; the edge weight is the mean of its
    correspondence weights (`src_dst_weights_1`), a cheap odometry-quality
    proxy."""

    def fn(src: torch.Tensor, dst: torch.Tensor):
        device = next(model.parameters()).device
        Ts, ws = [], []
        for s in range(0, src.shape[0], MAX_BATCH):
            out = serve_register(model, src[s:s + MAX_BATCH], dst[s:s + MAX_BATCH],
                                 device=device)
            Ts.append(se3.pack(out['rotation'], out['translation']))
            ws.append(out['weights'].mean(-1))
        return torch.cat(Ts), torch.cat(ws)

    return fn


def icp_register_fn(method: str = 'point_to_plane', threshold: float = 1.0,
                    max_iters: int = 30) -> RegisterFn:
    """ICP from the identity as the edge registrar (no trained weights
    needed; `eval/icp.py::refine`), every edge weight 1."""

    def fn(src: torch.Tensor, dst: torch.Tensor):
        init = torch.eye(4, dtype=src.dtype, device=src.device).expand(src.shape[0], 4, 4)
        T = refine(src, dst, init, method=method, threshold=threshold, max_iters=max_iters)
        return T, torch.ones(src.shape[0], dtype=src.dtype, device=src.device)

    return fn


def build_pose_graph(clouds: torch.Tensor, edges: Sequence[Tuple[int, int]],
                     register: RegisterFn,
                     init_poses: Optional[torch.Tensor] = None) -> PoseGraph:
    """Register every edge pair and assemble a PoseGraph on the clouds'
    device.

    Args:
        clouds: [K, N, 3] keyframe clouds, each in its own sensor frame.
        edges: (i, j) index pairs; they MUST hold the odometry chain (k, k+1)
            for k = 0..K-2 when `init_poses` is None (chained, they seed the
            initial trajectory); ValueError otherwise.
        register: batched pairwise registrar (see RegisterFn).
        init_poses: optional [K, 4, 4] initial world poses.
    """
    K = clouds.shape[0]
    ei = torch.tensor([e[0] for e in edges], dtype=torch.int64, device=clouds.device)
    ej = torch.tensor([e[1] for e in edges], dtype=torch.int64, device=clouds.device)
    Z, w = register(clouds[ej], clouds[ei])      # cloud j onto cloud i: X_i^{-1} X_j
    if init_poses is None:
        odo = {(a, b): m for a, b, m in zip(ei.tolist(), ej.tolist(), Z) if b == a + 1}
        if len(odo) != K - 1:
            raise ValueError('edges must contain the full odometry chain (k, k+1) to seed '
                             'initial poses')
        poses = [torch.eye(4, dtype=clouds.dtype, device=clouds.device)]
        with fp32_numerics():
            for k in range(K - 1):
                poses.append(poses[-1] @ odo[(k, k + 1)])
        init_poses = torch.stack(poses)
    return PoseGraph(init_poses, ei, ej, Z, w)
