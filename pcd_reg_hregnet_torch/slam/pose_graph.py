"""Sequence-level pose-graph optimisation, Gauss-Newton on SE(3) (port of
`pcd_reg_hregnet_tpu/slam/pose_graph.py`).

Formulation (right-perturbation pose-graph GN, as in the JAX package):
  variables   X_k in SE(3), k = 0..K-1 (keyframe poses, world frame)
  constraints (i, j, Z_ij, w_ij): measured relative pose Z_ij ~ X_i^{-1} X_j
  residual    r = log(Z^{-1} X_i^{-1} X_j)                [6]
  Jacobians   J_j =  Jr^{-1}(r),  J_i = -Jr^{-1}(r) Ad(X_j^{-1} X_i)
              with Jr^{-1}(r) ~ I + ad(r)/2
  update      X_k <- X_k exp(dx_k)

All M constraints are processed as one batch; the dense normal system
H [6K, 6K] is built by block scatter-adds (`index_put_(accumulate=True)`)
and solved on the graph's device; pose 0 is anchored by a strong prior.
Geometry runs in f32 without TF32 (`core.device.fp32_numerics`).

Across ranks (`torch.distributed`, NCCL on the card, gloo on the CPU):
`distributed_optimize` shards the constraints and all-reduces (H, b);
`schur_optimize` gives each rank one contiguous keyframe chunk, eliminates
its interior poses and all-reduces the separator system.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import fp32_numerics
from ..geometry import se3
from ..parallel import distributed

ANCHOR = 1e6


class PoseGraph(NamedTuple):
    """Fixed-shape pose-graph problem.

    poses: [K, 4, 4] initial keyframe poses.
    edges_i, edges_j: [M] int64 endpoint indices.
    measurements: [M, 4, 4] relative poses Z_ij ~ X_i^{-1} X_j.
    weights: [M] scalar information weights (0 disables an edge, so a graph
        can be padded to a fixed shape).
    """
    poses: torch.Tensor
    edges_i: torch.Tensor
    edges_j: torch.Tensor
    measurements: torch.Tensor
    weights: torch.Tensor


def residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Edge residuals r = log(Z^{-1} X_i^{-1} X_j): [M, 6]."""
    with fp32_numerics():
        Xi, Xj = poses[graph.edges_i], poses[graph.edges_j]
        return se3.log(se3.inverse(graph.measurements) @ se3.inverse(Xi) @ Xj)


def _edge_system(poses: torch.Tensor, graph: PoseGraph):
    """Per-edge residuals and Jacobian blocks: r [M, 6], J_i, J_j [M, 6, 6]."""
    Xi, Xj = poses[graph.edges_i], poses[graph.edges_j]
    rel_ij = se3.inverse(Xi) @ Xj
    r = se3.log(se3.inverse(graph.measurements) @ rel_ij)
    Jr_inv = torch.eye(6, dtype=r.dtype, device=r.device) + 0.5 * se3.ad(r)
    return r, -Jr_inv @ se3.adjoint(se3.inverse(rel_ij)), Jr_inv


def _block_system(poses: torch.Tensor, graph: PoseGraph, n: int):
    """Blocks of the normal equations of `graph` over `n` poses, no anchor:
    H [n, n, 6, 6], b [n, 6]."""
    r, J_i, J_j = _edge_system(poses, graph)
    w = graph.weights[:, None, None]
    Jit, Jjt = J_i.transpose(-1, -2), J_j.transpose(-1, -2)
    H_ij = Jit @ J_j * w
    ei, ej = graph.edges_i, graph.edges_j
    H = r.new_zeros((n, n, 6, 6))
    H.index_put_((ei, ei), Jit @ J_i * w, accumulate=True)
    H.index_put_((ej, ej), Jjt @ J_j * w, accumulate=True)
    H.index_put_((ei, ej), H_ij, accumulate=True)
    H.index_put_((ej, ei), H_ij.transpose(-1, -2), accumulate=True)
    b = r.new_zeros((n, 6))
    b.index_put_((ei,), torch.einsum('mab,mb->ma', Jit * w, r), accumulate=True)
    b.index_put_((ej,), torch.einsum('mab,mb->ma', Jjt * w, r), accumulate=True)
    return H, b


def _dense(H: torch.Tensor, b: torch.Tensor):
    """[n, n, 6, 6], [n, 6] -> [6n, 6n], [6n]."""
    n = H.shape[0]
    return H.permute(0, 2, 1, 3).reshape(n * 6, n * 6), b.reshape(n * 6)


def _normal_equations(poses: torch.Tensor, graph: PoseGraph):
    """Dense H [6K, 6K], b [6K], with the gauge prior on pose 0."""
    K = poses.shape[0]
    H, b = _dense(*_block_system(poses, graph, K))
    anchor = H.new_zeros(K * 6)
    anchor[:6] = ANCHOR
    return H + torch.diag(anchor), b


def _step(poses: torch.Tensor, H: torch.Tensor, b: torch.Tensor, damping: float):
    K = poses.shape[0]
    H = H + damping * torch.eye(K * 6, dtype=H.dtype, device=H.device)
    dx = -torch.linalg.solve(H, b).reshape(K, 6)
    return poses @ se3.exp(dx)


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6) -> torch.Tensor:
    """Gauss-Newton pose-graph solve on the graph's device; returns the
    optimised poses [K, 4, 4]."""
    poses = graph.poses
    with fp32_numerics():
        for _ in range(iters):
            poses = _step(poses, *_normal_equations(poses, graph), damping)
    return poses


def chi2(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Weighted squared residual norm (the optimisation objective)."""
    r = residuals(poses, graph)
    return torch.sum(graph.weights * torch.sum(r * r, dim=-1))


def _group_of(mesh, axis_name: str):
    """The process group of `mesh`'s `axis_name` (a `DeviceMesh`), or the
    default group for None."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(axis_name) if axis_name in names else mesh.get_group()


def _all_reduce(t: torch.Tensor, group) -> None:
    """Sum `t` over the group in place (nothing to do in one process)."""
    if distributed.active():
        dist.all_reduce(t, group=group)


# ---------------------------------------------------------------------------
# distributed (constraint-parallel) solve
# ---------------------------------------------------------------------------

def distributed_optimize(graph: PoseGraph, mesh=None, iters: int = 10,
                         damping: float = 1e-6, axis_name: str = 'data') -> torch.Tensor:
    """Pose-graph GN with the constraints sharded over the ranks of `mesh`
    (a `DeviceMesh`, or None for the default group).

    Every rank holds the whole graph and builds the normal equations of its
    contiguous shard of M / world edges; one all-reduce sums (H, b); every
    rank solves the (small, replicated) dense system.  M must be a multiple
    of the world size: pad with zero-weight edges.
    """
    group = _group_of(mesh, axis_name)
    n, r = distributed.world_size(group), distributed.rank(group)
    M, K = graph.weights.shape[0], graph.poses.shape[0]
    if M % n:
        raise ValueError(f'{M} edges do not divide over {n} ranks: pad with zero-weight edges')
    per = M // n
    local = PoseGraph(graph.poses, *(a[r * per:(r + 1) * per] for a in graph[1:]))
    poses = graph.poses
    with fp32_numerics():
        for _ in range(iters):
            H, b = _normal_equations(poses, local._replace(poses=poses))
            # every shard added the anchor prior: keep one in the reduced total
            anchor = H.new_zeros(K * 6)
            anchor[:6] = ANCHOR * (n - 1) / n
            H = H - torch.diag(anchor)
            Hb = torch.cat([H.reshape(-1), b])
            _all_reduce(Hb, group)
            poses = _step(poses, Hb[:-K * 6].reshape(K * 6, K * 6), Hb[-K * 6:], damping)
    return poses


# ---------------------------------------------------------------------------
# keyframe-partitioned Schur-complement solve
# ---------------------------------------------------------------------------

class PartitionedGraph(NamedTuple):
    """A pose graph partitioned into `P` contiguous keyframe chunks of
    length L = K // P (one per rank).  The first and last pose of a chunk
    are its separators (2P of them), the rest interior.  Edges inside a
    chunk are its local edges (indices rebased to 0..L-1, zero-weight padded
    to E_max); edges across chunks must join separators (`cross_*`, indexed
    into the separator order: chunk p's are 2p = pose p*L and 2p+1 = pose
    p*L + L - 1).

    local_*: [P, E_max] / [P, E_max, 4, 4]; cross_*: [E_c] / [E_c, 4, 4].
    """
    poses: torch.Tensor
    local_i: torch.Tensor
    local_j: torch.Tensor
    local_Z: torch.Tensor
    local_w: torch.Tensor
    cross_i: torch.Tensor
    cross_j: torch.Tensor
    cross_Z: torch.Tensor
    cross_w: torch.Tensor


def partition_graph(graph: PoseGraph, num_partitions: int) -> PartitionedGraph:
    """Host-side partitioner: split a PoseGraph into contiguous chunks.

    Raises ValueError if K is not divisible by `num_partitions`, chunks are
    shorter than 3 poses, or a cross-chunk edge touches an interior pose.
    """
    K = graph.poses.shape[0]
    P = num_partitions
    if K % P:
        raise ValueError(f'K={K} keyframes not divisible by P={P}')
    L = K // P
    if L < 3:
        raise ValueError(f'chunk length {L} < 3: no interior poses to eliminate')
    ei, ej = (graph.edges_i.cpu().numpy(), graph.edges_j.cpu().numpy())
    Z, w = graph.measurements.cpu().numpy(), graph.weights.cpu().numpy()

    def sep_id(k):
        p, rem = divmod(int(k), L)
        return 2 * p if rem == 0 else 2 * p + 1 if rem == L - 1 else None

    local = [[] for _ in range(P)]
    cross = []
    for m in range(len(ei)):
        if ei[m] // L == ej[m] // L:
            local[ei[m] // L].append(m)
        else:
            si, sj = sep_id(ei[m]), sep_id(ej[m])
            if si is None or sj is None:
                raise ValueError(f'cross-chunk edge ({ei[m]},{ej[m]}) touches an interior '
                                 f'pose; cross edges must connect chunk-boundary poses')
            cross.append((si, sj, m))

    E_max = max(1, max(len(l) for l in local))
    li = np.zeros((P, E_max), np.int64)
    lj = np.zeros((P, E_max), np.int64)
    lZ = np.tile(np.eye(4, dtype=Z.dtype), (P, E_max, 1, 1))
    lw = np.zeros((P, E_max), w.dtype)
    for p in range(P):
        for e, m in enumerate(local[p]):
            li[p, e], lj[p, e] = ei[m] - p * L, ej[m] - p * L
            lZ[p, e], lw[p, e] = Z[m], w[m]
    E_c = max(1, len(cross))
    ci = np.zeros((E_c,), np.int64)
    cj = np.zeros((E_c,), np.int64)
    cZ = np.tile(np.eye(4, dtype=Z.dtype), (E_c, 1, 1))
    cw = np.zeros((E_c,), w.dtype)
    for e, (si, sj, m) in enumerate(cross):
        ci[e], cj[e], cZ[e], cw[e] = si, sj, Z[m], w[m]
    dev = graph.poses.device
    return PartitionedGraph(graph.poses, *(torch.from_numpy(a).to(dev)
                                           for a in (li, lj, lZ, lw, ci, cj, cZ, cw)))


def schur_optimize(pg: PartitionedGraph, mesh=None, iters: int = 10,
                   damping: float = 1e-6, axis_name: str = 'data') -> torch.Tensor:
    """Distributed Gauss-Newton with Schur-complement elimination, one rank
    per partition (`mesh` a `DeviceMesh`, or None for the default group).

    Per iteration, on rank p (keyframe chunk p):
      1. the chunk-local normal system over its L poses;
      2. its L-2 interior poses eliminated by Cholesky:
         S_p = H_ss - H_si H_ii^{-1} H_is, and the reduced right-hand side;
      3. one all-reduce of the [12P, 12P] separator system; every rank adds
         the replicated cross-chunk edges and the anchor on pose 0, and
         solves it;
      4. the interior update back-substituted locally,
         dx_i = -H_ii^{-1} (b_i + H_is dx_s), and the chunks all-gathered.
    Returns the optimised poses [K, 4, 4].
    """
    group = _group_of(mesh, axis_name)
    nP, E_max = pg.local_w.shape
    world = distributed.world_size(group)
    if world != nP:
        raise ValueError(f'schur_optimize needs one rank per partition: graph has {nP} '
                         f'partitions, the group has {world} ranks')
    p = distributed.rank(group)
    K = pg.poses.shape[0]
    L = K // nP
    S_dim, nI = 2 * nP * 6, (L - 2) * 6
    local_edges = (pg.local_i[p], pg.local_j[p], pg.local_Z[p], pg.local_w[p])
    perm = torch.cat([torch.arange(1, L - 1), torch.tensor([0, L - 1])]).to(pg.poses.device)
    eye = torch.eye(S_dim, dtype=pg.poses.dtype, device=pg.poses.device)
    anchor = torch.zeros(S_dim, dtype=pg.poses.dtype, device=pg.poses.device)
    anchor[:6] = ANCHOR

    poses = pg.poses
    with fp32_numerics():
        for _ in range(iters):
            chunks = poses.reshape(nP, L, 4, 4)
            sep = chunks[:, [0, L - 1]].reshape(2 * nP, 4, 4)
            chunk = chunks[p]
            Hb, bb = _block_system(chunk, PoseGraph(chunk, *local_edges), L)
            Hp, bp = _dense(Hb[perm][:, perm], bb[perm])      # separators last
            H_ii = Hp[:nI, :nI] + damping * torch.eye(nI, dtype=Hp.dtype, device=Hp.device)
            H_is, H_ss = Hp[:nI, nI:], Hp[nI:, nI:]
            b_i, b_s = bp[:nI], bp[nI:]
            chol = torch.linalg.cholesky(H_ii)
            Y = torch.cholesky_solve(H_is, chol)
            y = torch.cholesky_solve(b_i[:, None], chol)[:, 0]
            Sr = torch.zeros(S_dim * S_dim + S_dim, dtype=Hp.dtype, device=Hp.device)
            S, rhs = Sr[:S_dim * S_dim].view(S_dim, S_dim), Sr[S_dim * S_dim:]
            off = p * 12
            S[off:off + 12, off:off + 12] = H_ss - H_is.T @ Y
            rhs[off:off + 12] = b_s - H_is.T @ y
            _all_reduce(Sr, group)
            Hc, bc = _dense(*_block_system(sep, PoseGraph(sep, pg.cross_i, pg.cross_j,
                                                          pg.cross_Z, pg.cross_w), 2 * nP))
            S = S + Hc + damping * eye + torch.diag(anchor)
            dx_s = -torch.linalg.solve(S, rhs + bc)
            dx_sp = dx_s[off:off + 12]
            dx_i = -torch.cholesky_solve((b_i + H_is @ dx_sp)[:, None], chol)[:, 0]
            dx = torch.cat([dx_sp[:6], dx_i, dx_sp[6:]]).reshape(L, 6)
            new = (chunk @ se3.exp(dx)).contiguous()
            gathered = [new]
            if distributed.active():
                gathered = [torch.empty_like(new) for _ in range(world)]
                dist.all_gather(gathered, new, group=group)
            poses = torch.cat(gathered)
    return poses
