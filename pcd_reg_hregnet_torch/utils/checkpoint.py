"""Checkpoints of the port: the exported JAX weights, and train checkpoints
(counterparts of `pcd_reg_hregnet_tpu/train/loop.py::restore_params`,
`save_checkpoint`, `restore_checkpoint` and `cli.py::_ckpt_config`).

The JAX package saves orbax checkpoints, which need orbax and tensorstore
to read.  `tools/export_torch_weights.py` turns one into an uncompressed
`.npz` of flax leaves (`params/...`, `batch_stats/...`, `/`-joined paths)
beside its `meta.json` (`<stem>.meta.json`); this module reads them with
numpy alone.  The model's leaves are those two collections; the training
objective's own submodules, the MI discriminators, are under
`objective/params/mi_loss/...` and load apart (`load_objective`), so a
model loads strictly without them.  A train checkpoint is a directory
holding `state.pt` (the model's `state_dict`, the objective's other
leaves, the optimizer's state, step, epoch, best metrics and the config
JSON, by `torch.save`) and `meta.json` (the same but the tensors).
`read` takes either kind and returns the same three things, so every
entry point that takes weights takes both.

A feats pretrain objective (`train/feats.py::FeatsObjective`) has no
`model`: its one submodule, `feature_extraction`, is its model, keyed
`feature_extraction.*` both in its train checkpoints and in an exported
feats checkpoint (`params/feature_extraction/...`).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from ..core.config import ASSETS_DIR, Config
from .convert import from_flax

FLAGSHIP = ASSETS_DIR / 'r5_v11_knn_best_rre.npz'   # reg_v11, model_v6
A1 = ASSETS_DIR / 'r4_v6_50_best_rre.npz'           # reg_v6, model_v2
WARM = ASSETS_DIR / 'r4_v11_warm_best_rre.npz'      # reg_v11 warm-started from FEATS
FEATS = ASSETS_DIR / 'r5_feats_desc_feats_descriptor.npz'   # descriptor stage, model_v6
NONE = ASSETS_DIR / 'r4_v11_none_best_rre.npz'      # reg_v11 with ptv3_cpe='none'
OBJECTIVE = 'objective'
TRAIN_STATE = 'state.pt'


def meta_path(path: str | Path) -> Path:
    """`<stem>.meta.json` beside an exported `.npz`; `meta.json` inside a
    train checkpoint directory."""
    path = Path(path)
    if path.is_dir():
        return path / 'meta.json'
    return path.with_name(path.name.removesuffix('.npz') + '.meta.json')


def load_config(path: str | Path) -> Config:
    """The full `Config` recorded in the checkpoint's `meta.json`."""
    with open(meta_path(path)) as f:
        return Config.from_json(json.load(f)['config'])


def read(path: str | Path) -> tuple[Config, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(Config, the model's `state_dict`, the `state_dict` of the
    objective's other submodules) of an exported `.npz` or of a train
    checkpoint directory (`state.pt` + `meta.json`), on the CPU."""
    path = Path(path)
    if path.is_dir():
        if not (path / TRAIN_STATE).exists():
            raise FileNotFoundError(f'{path}: a directory without {TRAIN_STATE} is no train '
                                    'checkpoint')
        saved = torch.load(path / TRAIN_STATE, map_location='cpu', weights_only=True)
        return Config.from_json(saved['config']), saved['model'], saved['objective']
    variables = load_variables(path)
    return load_config(path), from_flax(variables), from_flax(variables.get(OBJECTIVE, {}))


def load_variables(path: str | Path) -> dict:
    """{'params': ..., 'batch_stats': ...} as nested dicts of numpy arrays."""
    variables: dict = {}
    with np.load(path) as npz:
        for key in npz.files:
            *parents, leaf = key.split('/')
            node = variables
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return variables


def load(path: str | Path = FLAGSHIP) -> tuple[Config, dict[str, torch.Tensor]]:
    """(Config, state_dict) of a checkpoint's model (`read`)."""
    return read(path)[:2]


def load_objective(path: str | Path) -> dict[str, torch.Tensor]:
    """The `state_dict` of the objective's submodules other than the model
    (`mi_loss.global_d.Dense_0.weight`, ...); empty when the checkpoint
    holds none."""
    return read(path)[2]


def model_of(objective: torch.nn.Module) -> torch.nn.Module:
    """The module a checkpoint holds as the model: a registration
    objective's `model`, or a feats objective itself."""
    return getattr(objective, 'model', objective)


def objective_state(objective: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The objective's `state_dict` without the model's entries."""
    if model_of(objective) is objective:
        return {}
    return {k: v for k, v in objective.state_dict().items() if not k.startswith('model.')}


def load_objective_state(objective: torch.nn.Module, state: dict, source) -> None:
    """Load `state` into the objective's submodules other than the model,
    strictly: the same names, none missing, none left over."""
    want = set(objective_state(objective))
    if set(state) != want:
        raise ValueError(f'{source}: the objective holds {sorted(want)[:4]}..., the checkpoint '
                         f'{sorted(state)[:4]}... ({len(want)} against {len(state)} leaves)')
    objective.load_state_dict(state, strict=False)   # strict but for the model's own keys


def save_train(path: str | Path, state, cfg: Config) -> Path:
    """Write the train state (`train.loop.TrainState`) as a checkpoint
    directory at `path`; each file is replaced whole (written beside, then
    renamed), so an interrupted save leaves the previous one."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {'step': state.step, 'epoch': state.epoch, 'best': dict(state.best),
            'config': cfg.to_json()}
    payload = dict(meta, model=model_of(state.objective).state_dict(),
                   objective=objective_state(state.objective),
                   optimizer=state.optimizer.state_dict())
    torch.save(payload, path / (TRAIN_STATE + '.tmp'))
    os.replace(path / (TRAIN_STATE + '.tmp'), path / TRAIN_STATE)
    with open(path / 'meta.json.tmp', 'w') as f:
        json.dump(meta, f)
    os.replace(path / 'meta.json.tmp', path / 'meta.json')
    return path


def restore_train(path: str | Path, state) -> None:
    """Load a train checkpoint written by `save_train` into `state`: model
    and the objective's other leaves (the MI discriminators; both strict),
    optimizer, step, epoch and best metrics."""
    device = next(state.objective.parameters()).device
    saved = torch.load(Path(path) / TRAIN_STATE, map_location=device, weights_only=True)
    model_of(state.objective).load_state_dict(saved['model'], strict=True)
    load_objective_state(state.objective, saved['objective'], path)
    state.optimizer.load_state_dict(saved['optimizer'])
    state.step, state.epoch = int(saved['step']), int(saved['epoch'])
    state.best.update({k: float(v) for k, v in saved['best'].items() if k in state.best})
