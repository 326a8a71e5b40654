"""Split evaluation: network + multi-layer metrics + ICP (port of
`pcd_reg_hregnet_tpu/eval/runner.py::evaluate`, `evaluate_icp_only`).

One device: batches of `cfg.data.batch_size` pairs go through the model on
the card (or on the CPU when the caller passes ``device='cpu'``), with the
ragged last batch kept as it is.  The results dict and its JSON file have
the JAX package's keys and metadata.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..data import batch_iterator, load_dataset
from ..geometry import se3
from ..models import zoo
from .calib_eval import CalibEval, MultiLayerCalibEval
from .icp import refine

ICP_METHODS = (None, 'point_to_point', 'point_to_plane')


def load_model(cfg: Config, weights: str | Path,
               device: str | torch.device = 'cuda') -> torch.nn.Module:
    """The exported checkpoint at `weights` as a model on `device`; the
    checkpoint must record `cfg.model`."""
    model = zoo.build(cfg.model.name, device=device, weights=Path(weights))
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

    `weights` is an exported checkpoint (`utils/checkpoint.py`).  `icp` in
    {None, 'point_to_point', 'point_to_plane'} appends the refined pose as
    a fourth layer.  A pair succeeds for the recall when its mean
    |per-axis| errors are below `recall_rot_deg` and `recall_trans_m`.
    """
    if seq_parallel and seq_parallel > 1:
        raise NotImplementedError('seq_parallel > 1: sequence parallelism is not ported '
                                  'yet (ROADMAP queue 1 item 13)')
    if icp not in ICP_METHODS:
        raise ValueError(f'unknown ICP method {icp!r}; one of {ICP_METHODS}')
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
    if results_path:
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
