"""Sequence parallelism over the serialized point order (port of
`pcd_reg_hregnet_tpu/parallel/sequence.py`) on `torch.distributed`.

The PTv3 encoder's serialized N axis is cut into contiguous shares, one
per rank of a group, each a multiple of the attention patch size: every
patch then lies wholly on one rank, and patch attention (K3) runs on the
rank's own patches with no communication.  Only the CPE mixes rows across
shares.

The JAX package marks the serialized activations with
`with_sharding_constraint` (`seq_constrain`) and lets GSPMD partition the
encoder and insert the collectives.  torch has no partitioner, so
`seq_constrain` has no counterpart: the encoder
(`models/ptv3.py::PointTransformerEncoder` with `seq_axis` set, under
`sequence_mesh`) takes its steps explicitly.  Each rank holds the whole
batch and the whole cloud (the eval keeps the batch replicated), and:

* the serialization, the CPE's kNN and the stem's depthwise conv run on
  the whole cloud on every rank; the rank then keeps its share of the
  stem's rows and of the kNN's indices and offsets (JAX's `seq_constrain`
  of the serialized features, `nbr_idx` and `rel`);
* in each block, the kNN CPE reads neighbours anywhere in the cloud: one
  all-gather of the block's input rows (`gather_rows`); the curve CPE
  takes a halo from the neighbouring shares (`halo_exchange`,
  `sharded_depthwise_conv`); LayerNorm, the Dense layers and eval-mode
  BatchNorm act per row, K3 per patch;
* after the last block one all-gather restores [B, N, C] for the inverse
  permutation (JAX's per-block `seq_constrain`, then its gather).

The path is eval only, as in the JAX package: the encoder refuses train
mode under a group (train-mode BatchNorm would need the statistics of
every share, and the collectives here carry no gradient).

Counterparts of the JAX module's functions:

* `check_patch_alignment`: the same check and messages;
* `sequence_sharding(n_points, group)`: this rank's slice of the N axis
  (JAX: the `NamedSharding` that splits it);
* `sequence_mesh(group)` / `active_sequence_mesh()`: bind a process
  group (or a `DeviceMesh` with a 'seq' dimension) for the encoders with
  `seq_axis` to read; `sequence_group(n)` makes the group of n ranks
  (JAX: the first n devices);
* `halo_exchange(x, halo, group)`: send/recv with the curve neighbours;
* `sharded_depthwise_conv` (JAX `shardmap_depthwise_conv`): a halo, then
  a 'VALID' depthwise `F.conv1d`;
* `sequence_apply` (JAX `gspmd_sequence_apply`): one module of one [B, N,
  C] input, such as a `PTv3Block`, on this rank's rows, its output
  gathered back to [B, N, C] on every rank.  The encoder takes (xyz, feat)
  and shares its rows only after its own serialization, so it is sharded
  through `seq_axis` and `sequence_mesh` instead.

Collectives: `dist.all_gather` and `dist.batch_isend_irecv`, on NCCL
(CUDA tensors) or gloo (CPU tensors).  A one-rank group still runs every
all-gather; its halo has no neighbour to exchange with and is zeros.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import distributed

_ACTIVE_SEQ_GROUP: list = []


def _group(group):
    """A process group from a group, a `DeviceMesh` (its 'seq' dimension)
    or None (the default group)."""
    if group is None:
        return dist.group.WORLD
    if hasattr(group, 'get_group'):
        return group.get_group('seq') if group.ndim > 1 else group.get_group()
    return group


def _global_rank(group, rank: int) -> int:
    return rank if group is dist.group.WORLD else dist.get_global_rank(group, rank)


def check_patch_alignment(n_points: int, patch_size: int, n_shards: int) -> None:
    """Shard size must be a multiple of the attention patch size — the
    invariant that makes sequence-sharded patch attention communication-
    free."""
    if n_points % n_shards:
        raise ValueError(f'N={n_points} must divide over {n_shards} shards')
    shard = n_points // n_shards
    if shard % patch_size:
        raise ValueError(
            f'shard size {shard} must be a multiple of patch_size '
            f'{patch_size} so no attention patch straddles a device')


def sequence_sharding(n_points: int, group=None, patch_size: Optional[int] = None) -> slice:
    """This rank's contiguous share of a serialized N axis split over
    `group`; with `patch_size`, each share must hold whole patches."""
    group = _group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    check_patch_alignment(n_points, patch_size or 1, n)
    per = n_points // n
    return slice(per * r, per * (r + 1))


def sequence_group(n_shards: int):
    """The group of `n_shards` consecutive ranks this rank belongs to
    (the whole default group when it has `n_shards` ranks; more ranks form
    replicas, each sharding the same work).  Raises RuntimeError without a
    process group and ValueError when the group has fewer ranks than
    `n_shards` or is not a multiple of it."""
    if not distributed.active():
        raise RuntimeError(f'sequence parallelism over {n_shards} ranks needs a process '
                           'group: call parallel.distributed.initialize() first')
    world = distributed.world_size()
    if n_shards > world:
        raise ValueError(f'seq_parallel={n_shards} asks for more ranks than the {world} '
                         'of the process group')
    if n_shards < 1 or world % n_shards:
        raise ValueError(f'the {world} ranks of the process group do not divide into groups '
                         f'of seq_parallel={n_shards}')
    if n_shards == world:
        return dist.group.WORLD
    # every rank takes part in creating every group
    groups = [dist.new_group(list(range(lo, lo + n_shards)))
              for lo in range(0, world, n_shards)]
    return groups[dist.get_rank() // n_shards]


@contextlib.contextmanager
def sequence_mesh(group):
    """Make `group` (a process group, or a `DeviceMesh` with a 'seq'
    dimension) the one that encoders with `seq_axis` shard over for the
    duration of the block."""
    _ACTIVE_SEQ_GROUP.append(_group(group))
    try:
        yield group
    finally:
        _ACTIVE_SEQ_GROUP.pop()


def active_sequence_mesh():
    """The group bound by the innermost `sequence_mesh`, else None."""
    return _ACTIVE_SEQ_GROUP[-1] if _ACTIVE_SEQ_GROUP else None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's share [B, n_local, ...] joined in rank order along
    dim 1: [B, n_local * ranks, ...] on every rank (one all-gather)."""
    group = _group(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Prepend the previous rank's last `halo` rows and append the next
    rank's first `halo` rows (zeros at the curve ends, as 'SAME' padding).

    x: [B, n_local, C] (this rank's share) -> [B, n_local + 2*halo, C].
    """
    group = _group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if not 0 < halo <= x.shape[1]:
        raise ValueError(f'halo {halo} must be in 1..{x.shape[1]} (the rows of a share)')
    x = x.contiguous()
    prev_tail = x.new_zeros((x.shape[0], halo) + x.shape[2:])
    next_head = torch.zeros_like(prev_tail)
    ops = []
    if r > 0:
        peer = _global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, prev_tail, peer, group)]
    if r < n - 1:
        peer = _global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, next_head, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([prev_tail, x, next_head], dim=1)


def sharded_depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """'SAME' depthwise conv along a sequence-sharded axis: this rank's
    share x [B, n_local, C], weight [C, 1, w] (w odd, `nn.Conv1d(groups=C)`
    layout) -> [B, n_local, C], equal to the rows of the unsharded conv."""
    w = weight.shape[-1]
    if w % 2 == 0:
        raise ValueError(f'kernel width {w} must be odd for a centred halo')
    xh = halo_exchange(x, w // 2, group)
    y = F.conv1d(xh.transpose(1, 2), weight, bias, groups=x.shape[-1])
    return y.transpose(1, 2)


def sequence_apply(module, x: torch.Tensor, group=None, patch_size: Optional[int] = None):
    """Apply `module` (a `PTv3Block` or any module whose `forward(x,
    group=)` takes this rank's rows) with the N axis of x [B, N, C] sharded
    over `group`; x is the whole input, the same on every rank.  Returns the
    output gathered to [B, N, C] on every rank.  With `patch_size`, a share
    that would split a patch raises ValueError."""
    group = _group(group if group is not None else active_sequence_mesh())
    share = sequence_sharding(x.shape[1], group, patch_size)
    return gather_rows(module(x[:, share], group=group), group)
