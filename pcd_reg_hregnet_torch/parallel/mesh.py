"""A 1-D data-parallel mesh and the batch/state placement helpers (port of
`pcd_reg_hregnet_tpu/parallel/mesh.py`) on `torch.distributed`.

Where the JAX package compiles one sharded program (GSPMD inserts the
gradient and BatchNorm collectives), the port runs one process per card:
each rank holds a replica of the state (`replicated`: a broadcast from
rank 0), loads its rows of every batch (`batch_sharding` / `shard_batch`),
and the train step all-reduces the gradient and the BatchNorm sums
(`train/loop.py`, `models/layers.py::BatchNorm`).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist

from . import distributed


def make_mesh(data_parallel: int = -1, axis_name: str = 'data'):
    """A 1-D `DeviceMesh` over the first `data_parallel` ranks (all with -1
    or 0).  Raises ValueError when more ranks are asked for than the group
    has (the JAX package's silently takes fewer devices), RuntimeError
    without a process group."""
    n = distributed.world_size()
    if data_parallel in (-1, 0):
        data_parallel = n
    if data_parallel > n:
        raise ValueError(f'data_parallel={data_parallel} asks for more ranks than the '
                         f'{n} of the process group')
    if not distributed.active():
        raise RuntimeError('make_mesh needs a process group: call parallel.distributed.'
                           'initialize() first')
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = distributed.group_device_type()
    if data_parallel == n:
        return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, torch.arange(data_parallel), mesh_dim_names=(axis_name,))


def batch_sharding(mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch split over every axis of `mesh`,
    in the mesh's row-major order.  Raises on a rank outside the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f'rank {dist.get_rank()} is not in {mesh}')
    n, r = mesh.size(), int(np.ravel_multi_index(coord, tuple(mesh.shape)))
    if global_batch % n:
        raise ValueError(f'global batch {global_batch} does not divide over {n} ranks')
    per = global_batch // n
    return slice(per * r, per * (r + 1))


def replicated(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Make every rank's `tensors` (parameters, buffers) rank 0's, in
    place: one broadcast each.  Nothing to do without a group."""
    if distributed.world_size(group) == 1:
        return
    for t in tensors:
        dist.broadcast(t.data, 0, group=group)


def shard_batch(batch, mesh):
    """This rank's rows of every array of a global batch dict."""
    sl = batch_sharding(mesh, len(next(iter(batch.values()))))
    return {k: v[sl] for k, v in batch.items()}


def pad_to_multiple(batch, multiple: int):
    """Pad the batch axis to a multiple of `multiple` by repeating the first
    rows (the JAX package's padding)."""
    def pad(x):
        rem = (-x.shape[0]) % multiple
        return x if rem == 0 else np.concatenate([x, x[:rem]], axis=0)
    return {k: pad(v) for k, v in batch.items()}
