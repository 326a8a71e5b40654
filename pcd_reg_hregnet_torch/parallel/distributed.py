"""Multi-process data parallelism on `torch.distributed` (port of
`pcd_reg_hregnet_tpu/parallel/distributed.py`).

* `initialize()` joins the process group a launcher describes: torchrun's
  ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, or the JAX
  package's ``COORDINATOR_ADDRESS`` (``host:port``) / ``PROCESS_COUNT`` /
  ``PROCESS_INDEX``, or explicit arguments.  NCCL on the card, gloo on the
  CPU.  Without any of them it does nothing, as a single process should;
* `make_hybrid_mesh()` is a 2-D ``('dcn', 'ici')`` `DeviceMesh`: the inner
  axis spans the ranks of one host, the outer one the hosts;
* `process_local_batch_slice()` / `shard_global_batch()` /
  `data_sharding()` give a rank its rows of the global batch (every rank iterates the same global order and
  loads only its rows, `data.batch_iterator(local_slice=)`).

Run a data-parallel job as one process per card, e.g.

    torchrun --nproc-per-node 4 -m pcd_reg_hregnet_torch train --experiment reg_v11 ...
    COORDINATOR_ADDRESS=host0:29500 PROCESS_COUNT=4 PROCESS_INDEX=$i \\
        python -m pcd_reg_hregnet_torch train ...

(each rank takes the card ``LOCAL_RANK``, else ``rank % device_count``).
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def active() -> bool:
    """True when this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """The ranks of `group` (the default group), 1 without one."""
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    """This process's rank in `group`, 0 without one."""
    return dist.get_rank(group) if active() else 0


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str | torch.device | None = None) -> bool:
    """Join the process group (idempotent).

    `coordinator` is ``host:port`` (TCP) or a URL (``file:///path``).
    Resolution order: explicit arguments > torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` > the JAX package's
    ``COORDINATOR_ADDRESS`` / ``PROCESS_COUNT`` / ``PROCESS_INDEX``.  With
    none of them it is a no-op.  `device` picks the backend (NCCL for
    'cuda', gloo for 'cpu'; default: NCCL when a card is present) and, on
    the card, this rank's device (``LOCAL_RANK`` or rank modulo the cards).
    Returns True when the group has more than one rank, as the JAX
    package's returns whether a multi-process runtime is up.
    """
    if active():
        return world_size() > 1
    env = os.environ
    if coordinator is None and 'MASTER_ADDR' in env and 'WORLD_SIZE' in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env['WORLD_SIZE']) if num_processes is None else num_processes
        process_id = int(env.get('RANK', '0')) if process_id is None else process_id
    coordinator = coordinator or env.get('COORDINATOR_ADDRESS')
    if num_processes is None and env.get('PROCESS_COUNT'):
        num_processes = int(env['PROCESS_COUNT'])
    if process_id is None and 'PROCESS_INDEX' in env:
        process_id = int(env['PROCESS_INDEX'])
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(f'incomplete process-group description: coordinator {coordinator!r}, '
                         f'{num_processes} processes, process id {process_id}')
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('NCCL asked for but torch.cuda.is_available() is False; '
                               "pass device='cpu' for gloo")
        torch.cuda.set_device(int(env.get('LOCAL_RANK', process_id % torch.cuda.device_count())))
    init = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo', init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(minutes=10))
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group, if any."""
    if active():
        dist.destroy_process_group()


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun), else every rank."""
    return int(os.environ.get('LOCAL_WORLD_SIZE', world_size()))


def make_hybrid_mesh(ici_parallel: int = -1, dcn_parallel: int = -1):
    """A 2-D ``('dcn', 'ici')`` `DeviceMesh` over the group's ranks.

    `ici_parallel` defaults to the ranks of one host, `dcn_parallel` to the
    rest; rank r sits at (r // ici, r % ici), so the inner axis stays on one
    host (torchrun numbers a host's ranks consecutively).  Raises
    ValueError when dcn x ici is not the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    if ici_parallel in (-1, 0):
        ici_parallel = max(1, min(local_world_size(), n))
    if dcn_parallel in (-1, 0):
        dcn_parallel = n // ici_parallel
    if dcn_parallel * ici_parallel != n:
        raise ValueError(f'dcn({dcn_parallel}) x ici({ici_parallel}) != {n} ranks')
    if not active():
        raise RuntimeError('make_hybrid_mesh needs a process group: call initialize() first')
    return init_device_mesh(group_device_type(), (dcn_parallel, ici_parallel),
                            mesh_dim_names=('dcn', 'ici'))


def group_device_type() -> str:
    """The device type the default group's backend serves: 'cuda' for NCCL."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def data_sharding(mesh, global_batch: int) -> slice:
    """This rank's rows of a global batch split over both axes of a hybrid
    mesh (`mesh.batch_sharding`)."""
    from .mesh import batch_sharding
    return batch_sharding(mesh, global_batch)


def replicated_sharding(tensors, group=None) -> None:
    """Every rank's `tensors` made rank 0's, in place (`mesh.replicated`)."""
    from .mesh import replicated
    replicated(tensors, group)


def process_local_batch_slice(global_batch: int, group=None) -> slice:
    """This rank's rows of a global batch: `global_batch / world` consecutive
    rows.  Raises when the batch does not divide over the ranks."""
    n = world_size(group)
    if global_batch % n:
        raise ValueError(f'global batch {global_batch} does not divide over {n} ranks')
    per = global_batch // n
    lo = per * rank(group)
    return slice(lo, lo + per)


def shard_global_batch(batch, group=None):
    """This rank's rows of every array of a global batch dict."""
    sl = process_local_batch_slice(len(next(iter(batch.values()))), group)
    return {k: v[sl] for k, v in batch.items()}
