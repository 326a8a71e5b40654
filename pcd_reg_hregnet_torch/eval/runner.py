"""Split evaluation: network + multi-layer metrics + ICP (port of
`pcd_reg_hregnet_tpu/eval/runner.py::evaluate`, `evaluate_icp_only`).

Batches of `cfg.data.batch_size` pairs go through the model on the card
(or on the CPU when the caller passes ``device='cpu'``), with the ragged
last batch kept as it is.  The results dict and its JSON file have the JAX
package's keys and metadata.  `evaluate(seq_parallel=N)` shards the PTv3
encoders' serialized order over N ranks of the process group
(`parallel/sequence.py`), the batch replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..data import batch_iterator, load_dataset
from ..geometry import se3
from ..models import zoo
from ..parallel import distributed, sequence
from .calib_eval import CalibEval, MultiLayerCalibEval
from .icp import refine

ICP_METHODS = (None, 'point_to_point', 'point_to_plane')


def load_model(cfg: Config, weights: str | Path,
               device: str | torch.device = 'cuda') -> torch.nn.Module:
    """The checkpoint at `weights` (an exported `.npz` or a train checkpoint
    directory) as a model on `device`, in `cfg.model.compute_dtype` (an
    f32-trained checkpoint serves in bf16 so, as the JAX CLI's `eval
    --compute-dtype` runs it); it must record `cfg.model` otherwise."""
    model = zoo.build(cfg.model.name, device=device, weights=Path(weights),
                      compute_dtype=cfg.model.compute_dtype, seq_axis=cfg.model.seq_axis)
    if model.cfg != cfg.model:
        raise ValueError(f'{weights} records another model configuration than '
                         f'cfg.model:\n{model.cfg}\n{cfg.model}')
    return model


@torch.no_grad()
def evaluate(cfg: Config, weights: str | Path, *, split: str = 'test',
             icp: Optional[str] = None, icp_threshold: float = 1.0,
             icp_iters: int = 30, results_path: Optional[str] = None,
             dataset=None, seq_parallel: int = 0,
             recall_rot_deg: float = 1.0, recall_trans_m: float = 0.1,
             device: str | torch.device = 'cuda') -> Dict:
    """Run the model over a split; returns the combined results dict.

    `weights` is an exported `.npz` or a train checkpoint directory
    (`utils/checkpoint.py::read`).  `icp` in
    {None, 'point_to_point', 'point_to_plane'} appends the refined pose as
    a fourth layer.  A pair succeeds for the recall when its mean
    |per-axis| errors are below `recall_rot_deg` and `recall_trans_m`.

    `seq_parallel` = N >= 1 runs the PTv3 encoders sequence-sharded over
    N ranks of the process group (`parallel.sequence.sequence_group`; the
    group joined from a launcher's environment if none is yet): every rank
    computes the whole batch's results, rank 0 alone writes
    `results_path`.  N = 1 runs the sharded path on a one-rank group (the
    JAX package takes only N > 1 to its sharded path; the results are the
    same).  Raises ValueError for a backbone other than ptv3, a patch that
    would straddle two shares, or more shards than ranks; RuntimeError
    without a process group.
    """
    if icp not in ICP_METHODS:
        raise ValueError(f'unknown ICP method {icp!r}; one of {ICP_METHODS}')
    seq_ctx = contextlib.nullcontext()
    if seq_parallel:
        if cfg.model.backbone != 'ptv3':
            raise ValueError('--seq-parallel requires the ptv3 backbone '
                             f'(model is {cfg.model.backbone!r})')
        for i, lvl in enumerate(cfg.model.levels):
            sequence.check_patch_alignment(lvl.nsample, cfg.model.ptv3_patch_sizes[i],
                                           seq_parallel)
        distributed.initialize(device=resolve_device(device))
        seq_ctx = sequence.sequence_mesh(sequence.sequence_group(seq_parallel))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, seq_axis='seq'))
    with seq_ctx:
        return _evaluate(cfg, weights, split, icp, icp_threshold, icp_iters, results_path,
                         dataset, recall_rot_deg, recall_trans_m, device)


def _evaluate(cfg, weights, split, icp, icp_threshold, icp_iters, results_path, dataset,
              recall_rot_deg, recall_trans_m, device) -> Dict:
    model = load_model(cfg, weights, device)
    dev = next(model.parameters()).device
    ds = dataset if dataset is not None else load_dataset(cfg.data, split)
    num_layers = 3 + (1 if icp else 0)
    evaluator = MultiLayerCalibEval(num_layers=num_layers,
                                    translation_threshold=recall_trans_m,
                                    rotation_threshold=recall_rot_deg)
    for batch in batch_iterator(ds, cfg.data.batch_size, shuffle=False, drop_last=False):
        src = torch.from_numpy(batch['uncalibed_pcd']).to(dev)
        dst = torch.from_numpy(batch['pcd_left']).to(dev)
        out = model(src, dst)
        poses = [se3.pack(R, t) for R, t in zip(out['rotation'], out['translation'])]
        if icp:
            poses.append(refine(src, dst, poses[-1], icp, icp_threshold, icp_iters))
        for layer, pred in enumerate(poses):
            evaluator.add_batch(layer, batch['igt'], pred)

    metadata = {
        'dataset': cfg.data.dataset + cfg.data.version,
        'model': cfg.model.name,
        'translation': cfg.data.max_trans_error,
        'rotation': cfg.data.max_rot_error,
        'distribution': cfg.data.distribution,
        'icp': icp or 'none',
    }
    metadata['summary'] = evaluator.evaluators[num_layers - 1].summary()
    metadata['summary_network'] = evaluator.evaluators[2].summary()
    if results_path and distributed.rank() == 0:
        os.makedirs(os.path.dirname(results_path) or '.', exist_ok=True)
        return evaluator.save_all_results(results_path, metadata)
    combined = {f'layer_{i}': e.get_results() for i, e in evaluator.evaluators.items()}
    combined.update(metadata)
    return combined


@torch.no_grad()
def evaluate_icp_only(cfg: Config, *, icp: str = 'point_to_point',
                      split: str = 'test', icp_threshold: float = 1.0,
                      icp_iters: int = 100, results_path: Optional[str] = None,
                      dataset=None, device: str | torch.device = 'cuda') -> Dict:
    """Classical-ICP baseline: ICP from the identity pose, no network."""
    if icp not in ICP_METHODS[1:]:
        raise ValueError(f'unknown ICP method {icp!r}; one of {ICP_METHODS[1:]}')
    dev = resolve_device(device)
    ds = dataset if dataset is not None else load_dataset(cfg.data, split)
    evaluator = CalibEval()
    for batch in batch_iterator(ds, cfg.data.batch_size, shuffle=False, drop_last=False):
        src = torch.from_numpy(batch['uncalibed_pcd']).to(dev)
        dst = torch.from_numpy(batch['pcd_left']).to(dev)
        eye = torch.eye(4, device=dev).expand(src.shape[0], 4, 4)
        evaluator.add_batch(batch['igt'], refine(src, dst, eye, icp, icp_threshold, icp_iters))

    combined = {'layer_0': evaluator.get_results(),
                'summary': evaluator.summary(),
                'dataset': cfg.data.dataset + cfg.data.version,
                'model': f'icp_only_{icp}',
                'translation': cfg.data.max_trans_error,
                'rotation': cfg.data.max_rot_error,
                'icp': icp, 'icp_iters': icp_iters,
                'icp_threshold': icp_threshold}
    if results_path:
        os.makedirs(os.path.dirname(results_path) or '.', exist_ok=True)
        import json
        with open(results_path, 'w') as f:
            json.dump(combined, f, indent=2, default=float)
    return combined
