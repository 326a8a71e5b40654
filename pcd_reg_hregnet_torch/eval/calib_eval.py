"""Calibration-error evaluator (port of `pcd_reg_hregnet_tpu/eval/calib_eval.py`).

The per-batch math runs in f32 on the poses' device with TF32 off, as the
JAX code runs it at ``precision='highest'``; accumulation is host-side in
numpy lists, and the results dict and its JSON file have the JAX package's
keys.  Error convention: ``error = pred_tf @ gt_tf`` with ``gt_tf = igt``,
so a perfect prediction gives the identity.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import fp32_numerics
from ..geometry import rotations


@fp32_numerics()
def _batch_errors(gt_tf: torch.Tensor, pred_tf: torch.Tensor):
    """Per-batch error tensors: (err_euler_deg [B,3], err_trans [B,3],
    geodesic_deg [B], eucl [B], pred_euler_deg [B,3], pred_trans [B,3])."""
    error = torch.matmul(pred_tf, gt_tf)
    err_R, err_t = error[..., :3, :3], error[..., :3, 3]
    err_euler = torch.rad2deg(rotations.matrix_to_euler_xyz(err_R))
    trace = err_R[..., 0, 0] + err_R[..., 1, 1] + err_R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # atan2(sin, cos), not arccos: f32 arccos reads ~0.03 deg of phantom
    # error near the identity
    skew = torch.stack([err_R[..., 2, 1] - err_R[..., 1, 2],
                        err_R[..., 0, 2] - err_R[..., 2, 0],
                        err_R[..., 1, 0] - err_R[..., 0, 1]], dim=-1)
    sin_t = 0.5 * torch.linalg.norm(skew, dim=-1)
    geod = torch.rad2deg(torch.arctan2(sin_t, cos_t))
    eucl = torch.linalg.norm(err_t, dim=-1)
    pred_euler = torch.rad2deg(rotations.matrix_to_euler_xyz(pred_tf[..., :3, :3]))
    return err_euler, err_t, geod, eucl, pred_euler, pred_tf[..., :3, 3]


def pose_deviation(got: Dict, want: Dict) -> Dict[str, tuple[np.ndarray, np.ndarray]]:
    """Pair for pair, two results dicts of one split: for each layer in both,
    (max |R entry difference| [n], max |t difference| [n] in m), f64, with
    each pose rebuilt from its `pred_calib` (XYZ Euler degrees, metres)."""
    def poses(layer):
        p = torch.tensor(layer['pred_calib'], dtype=torch.float64)
        return rotations.euler_xyz_to_matrix(torch.deg2rad(p[:, :3])).numpy(), p[:, 3:].numpy()

    out = {}
    for name in sorted(set(got) & set(want)):
        if not name.startswith('layer_'):
            continue
        (Rg, tg), (Rw, tw) = poses(got[name]), poses(want[name])
        if len(Rg) != len(Rw):
            raise ValueError(f'{name}: {len(Rg)} pairs against {len(Rw)}')
        out[name] = (np.abs(Rg - Rw).max(axis=(1, 2)), np.abs(tg - tw).max(axis=1))
    return out


class CalibEval:
    """Accumulates per-sample pose errors."""

    def __init__(self, translation_threshold: Optional[float] = None,
                 rotation_threshold: Optional[float] = None):
        self.translation_threshold = translation_threshold
        self.rotation_threshold = rotation_threshold
        self.reset()

    def reset(self) -> None:
        self.loss_r, self.loss_t = [], []
        self.geodesic, self.eucl = [], []
        self.pred = []
        self.success = []

    def add_batch(self, gt_tf, pred_tf) -> None:
        """gt_tf, pred_tf [B, 4, 4] f32 (tensors or arrays); the math runs on
        `pred_tf`'s device."""
        pred_tf = torch.as_tensor(pred_tf, dtype=torch.float32)
        gt_tf = torch.as_tensor(gt_tf, dtype=torch.float32, device=pred_tf.device)
        e_r, e_t, geod, eucl, p_r, p_t = (a.cpu().numpy() for a in _batch_errors(gt_tf, pred_tf))
        self.loss_r.extend(e_r.tolist())
        self.loss_t.extend(e_t.tolist())
        self.geodesic.extend(geod.tolist())
        self.eucl.extend(eucl.tolist())
        self.pred.extend(np.concatenate([p_r, p_t], axis=-1).tolist())
        if self.translation_threshold is not None and self.rotation_threshold is not None:
            ok = (np.abs(e_t).mean(-1) < self.translation_threshold) & \
                 (np.abs(e_r).mean(-1) < self.rotation_threshold)
            self.success.extend(ok.tolist())

    def get_stats(self):
        """Mean |per-axis rotation| [deg], |per-axis translation| [m],
        mean geodesic/euclidean."""
        r = np.abs(np.asarray(self.loss_r)).mean(0)
        t = np.abs(np.asarray(self.loss_t)).mean(0)
        g = np.array([np.mean(self.geodesic), np.mean(self.eucl)])
        return r, t, g

    def get_sd(self):
        r = np.abs(np.asarray(self.loss_r)).std(0)
        t = np.abs(np.asarray(self.loss_t)).std(0)
        return r, t, np.std(self.geodesic), np.std(self.eucl)

    def compute_recall(self) -> float:
        if not self.loss_r or not self.success:
            return 0.0
        return float(np.mean(self.success))

    def get_results(self) -> Dict:
        r, t, g = self.get_stats()
        sd_r, sd_t, sd_dR, sd_dT = self.get_sd()
        return {
            'pred_calib': self.pred,
            'error_calib': np.concatenate(
                [np.asarray(self.loss_r), np.asarray(self.loss_t)], axis=1).tolist(),
            'rre': [float(v) for v in self.geodesic],
            'rte': [float(v) for v in self.eucl],
            'mean_error': r.tolist() + t.tolist() + g.tolist(),
            'sd': sd_r.tolist() + sd_t.tolist(),
            'mean_sd': [float(np.mean(sd_r)), float(np.mean(sd_t))],
            'mean_sd_dRT': [float(sd_dR), float(sd_dT)],
            'recall': self.compute_recall(),
        }

    def summary(self) -> Dict[str, float]:
        """Headline numbers: rotation/translation MAE and SD, RRE/RTE with
        their SD and 95th percentile."""
        r, t, _ = self.get_stats()
        sd_r, sd_t, sd_dR, sd_dT = self.get_sd()
        return {
            'rot_mae_deg': float(r.mean()), 'rot_sd_deg': float(sd_r.mean()),
            'trans_mae_m': float(t.mean()), 'trans_sd_m': float(sd_t.mean()),
            'rre_deg': float(np.mean(self.geodesic)), 'rre_sd': float(sd_dR),
            'rte_m': float(np.mean(self.eucl)), 'rte_sd': float(sd_dT),
            'rre_p95': float(np.percentile(self.geodesic, 95)),
            'rte_p95': float(np.percentile(self.eucl, 95)),
        }


class MultiLayerCalibEval:
    """One evaluator per pyramid layer."""

    def __init__(self, num_layers: int = 3, translation_threshold=None,
                 rotation_threshold=None):
        self.num_layers = num_layers
        self.evaluators = {i: CalibEval(translation_threshold, rotation_threshold)
                           for i in range(num_layers)}

    def reset(self) -> None:
        for e in self.evaluators.values():
            e.reset()

    def add_batch(self, layer: int, gt_tf, pred_tf) -> None:
        if layer not in self.evaluators:
            raise ValueError(f'layer {layer} not in 0..{self.num_layers - 1}')
        self.evaluators[layer].add_batch(gt_tf, pred_tf)

    def save_all_results(self, output_file: str, metadata: Optional[Dict] = None) -> Dict:
        combined = {f'layer_{i}': e.get_results() for i, e in self.evaluators.items()}
        combined.update(metadata or {})
        with open(output_file, 'w') as f:
            json.dump(combined, f, indent=4)
        return combined
