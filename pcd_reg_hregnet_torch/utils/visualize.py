"""Result / inference visualisation, headless matplotlib (port of
`pcd_reg_hregnet_tpu/utils/visualize.py`: the same plots and file names).

`VisualizeResults` plots an eval results dict (error distributions, RRE/RTE
histograms, per-layer box plots, recall curves); `FeatureMapVisualizer`
captures a port model's intermediate activations with forward hooks and
plots them; `InferenceVisualizer` draws BEV overlays and stitches them
into a GIF.  matplotlib is imported inside the functions that draw, never
at module import: the module imports where matplotlib is not installed.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


class VisualizeResults:
    """Plots over a CalibEval-style results dict (`eval/calib_eval.py`)."""

    def __init__(self, out_dir: str = 'plots'):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def error_distributions(self, results: Dict, name: str = 'errors') -> str:
        """Histogram+KDE-style panels of per-axis rotation/translation errors."""
        plt = _pyplot()
        err = np.asarray(results['error_calib'])  # [N, 6] = rot xyz deg, trans xyz m
        fig, axes = plt.subplots(2, 3, figsize=(12, 6))
        labels = ['roll [deg]', 'pitch [deg]', 'yaw [deg]',
                  'x [m]', 'y [m]', 'z [m]']
        for i, ax in enumerate(axes.flat):
            ax.hist(err[:, i], bins=40, density=True, alpha=0.7)
            ax.set_title(labels[i])
            ax.axvline(0, color='k', lw=0.5)
        fig.suptitle('Calibration error distributions')
        path = os.path.join(self.out_dir, f'{name}_dist.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def rre_histogram(self, results: Dict, name: str = 'rre') -> str:
        """Histogram of per-sample geodesic (RRE) / euclidean (RTE) errors.

        The failure-tail view: per-axis means hide heavy tails (a few
        near-180 deg flips can double the mean geodesic while leaving
        axis-mean errors tiny)."""
        plt = _pyplot()
        rre = np.asarray(results.get('rre', []))
        rte = np.asarray(results.get('rte', []))
        fig, (ax_r, ax_t) = plt.subplots(1, 2, figsize=(10, 4))
        ax_r.hist(rre, bins=60, log=True)
        ax_r.set_xlabel('RRE [deg]'); ax_r.set_ylabel('count (log)')
        ax_r.set_title(f'median {np.median(rre):.3f}, p95 '
                       f'{np.percentile(rre, 95):.3f}, max {rre.max():.2f}'
                       if rre.size else 'no rre data')
        ax_t.hist(rte, bins=60, log=True)
        ax_t.set_xlabel('RTE [m]')
        if rte.size:
            ax_t.set_title(f'median {np.median(rte):.3f}, p95 '
                           f'{np.percentile(rte, 95):.3f}, max {rte.max():.2f}')
        path = os.path.join(self.out_dir, f'{name}_hist.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def box_plots(self, layer_results: Dict[str, Dict], name: str = 'layers') -> str:
        """Per-layer box plots of |rotation| and |translation| errors."""
        plt = _pyplot()
        fig, (ax_r, ax_t) = plt.subplots(1, 2, figsize=(10, 4))
        rot_data, trans_data, labels = [], [], []
        for layer, res in layer_results.items():
            if not isinstance(res, dict) or 'error_calib' not in res:
                continue
            err = np.abs(np.asarray(res['error_calib']))
            rot_data.append(err[:, :3].mean(-1))
            trans_data.append(err[:, 3:].mean(-1))
            labels.append(layer)
        ax_r.boxplot(rot_data, tick_labels=labels)
        ax_r.set_ylabel('|rotation error| [deg]')
        ax_t.boxplot(trans_data, tick_labels=labels)
        ax_t.set_ylabel('|translation error| [m]')
        path = os.path.join(self.out_dir, f'{name}_box.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def recall_curve(self, results: Dict, max_rot: float = 2.0,
                     max_trans: float = 0.5, name: str = 'recall') -> str:
        """Recall vs error-threshold curves (visualize_results.py recall plot)."""
        plt = _pyplot()
        err = np.abs(np.asarray(results['error_calib']))
        rot = err[:, :3].mean(-1)
        trans = err[:, 3:].mean(-1)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
        ths_r = np.linspace(0, max_rot, 100)
        ax1.plot(ths_r, [(rot < t).mean() for t in ths_r])
        ax1.set_xlabel('rotation threshold [deg]'); ax1.set_ylabel('recall')
        ths_t = np.linspace(0, max_trans, 100)
        ax2.plot(ths_t, [(trans < t).mean() for t in ths_t])
        ax2.set_xlabel('translation threshold [m]')
        path = os.path.join(self.out_dir, f'{name}.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path


class FeatureMapVisualizer:
    """Intermediate-activation plots (the reference's forward-hook feature-map
    dumps).  `capture(model, src, dst)` runs one forward with a forward hook
    on every submodule and returns {module path: [outputs, one per call]};
    `flatten` turns that into {'path/key[i]': array}; `plot(...)` renders a
    captured [B, N, C] / [B, M, k, C] activation as a keypoint scatter
    coloured by channel magnitude plus a channel-activation heatmap.
    """

    def __init__(self, out_dir: str = 'plots'):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    @staticmethod
    def capture(model, src, dst, filter_fn=None) -> Dict[str, list]:
        """Outputs of every submodule (or those `filter_fn(path, module)`
        keeps) in one no-grad forward of `model(src, dst)`, by module path
        (`feature_extraction.detector_1`, ...)."""
        import torch
        captured: Dict[str, list] = {}
        hooks = []
        for path, module in model.named_modules():
            if path and (filter_fn is None or filter_fn(path, module)):
                hooks.append(module.register_forward_hook(
                    lambda m, args, out, path=path: captured.setdefault(path, []).append(out)))
        try:
            with torch.no_grad():
                model(src, dst)
        finally:
            for h in hooks:
                h.remove()
        return captured

    @staticmethod
    def flatten(intermediates) -> Dict[str, np.ndarray]:
        """Flatten the intermediates tree to {'path/to/module': array}."""
        out: Dict[str, np.ndarray] = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f'{prefix}/{k}' if prefix else k)
            elif isinstance(node, (tuple, list)):
                for i, v in enumerate(node):
                    walk(v, f'{prefix}[{i}]' if len(node) > 1 else prefix)
            elif hasattr(node, 'detach'):
                out[prefix] = node.detach().float().cpu().numpy()
            elif hasattr(node, 'shape'):
                out[prefix] = np.asarray(node)
        walk(intermediates, '')
        return out

    def plot(self, name: str, activation: np.ndarray,
             xyz: Optional[np.ndarray] = None, batch_index: int = 0) -> str:
        plt = _pyplot()
        act = np.asarray(activation)
        if act.ndim == 4:                      # [B, M, k, C] -> reduce over k
            act = act.max(axis=2)
        act = act[batch_index]                 # [N, C]
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
        mag = np.linalg.norm(act, axis=-1)
        if xyz is not None:
            pts = np.asarray(xyz)[batch_index]
            sc = ax1.scatter(pts[:, 0], pts[:, 1], c=mag, s=2, cmap='viridis')
            ax1.set_aspect('equal')
        else:
            sc = ax1.scatter(np.arange(mag.shape[0]), mag, c=mag, s=2,
                             cmap='viridis')
        fig.colorbar(sc, ax=ax1, label='|feature|')
        ax1.set_title(f'{name}: per-point magnitude')
        n_show = min(64, act.shape[-1])
        ax2.imshow(act[:, :n_show].T, aspect='auto', cmap='viridis',
                   interpolation='nearest')
        ax2.set_xlabel('point'); ax2.set_ylabel('channel')
        ax2.set_title(f'{name}: first {n_show} channels')
        safe = name.replace('/', '_').replace('[', '_').replace(']', '')
        path = os.path.join(self.out_dir, f'featmap_{safe}.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path


class InferenceVisualizer:
    """BEV overlays of (target, decalibrated source, registered source)."""

    def __init__(self, out_dir: str = 'plots'):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def bev(self, dst: np.ndarray, src_uncalib: np.ndarray,
            src_registered: Optional[np.ndarray] = None,
            name: str = 'bev', lim: float = 80.0) -> str:
        plt = _pyplot()
        cols = 3 if src_registered is not None else 2
        fig, axes = plt.subplots(1, cols, figsize=(5 * cols, 5))
        panels = [('target + decalibrated', src_uncalib),
                  ('target + registered', src_registered)]
        axes[0].scatter(dst[:, 0], dst[:, 1], s=0.3, c='tab:blue')
        axes[0].set_title('target')
        idx = 1
        for title, cloud in panels:
            if cloud is None:
                continue
            ax = axes[idx]
            ax.scatter(dst[:, 0], dst[:, 1], s=0.3, c='tab:blue', alpha=0.5)
            ax.scatter(cloud[:, 0], cloud[:, 1], s=0.3, c='tab:red', alpha=0.5)
            ax.set_title(title)
            idx += 1
        for ax in axes:
            ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim)
            ax.set_aspect('equal')
        path = os.path.join(self.out_dir, f'{name}.png')
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def sequence_video(self, frames, name: str = 'inference',
                       fps: int = 2) -> str:
        """Stitch per-frame BEV overlays into an animated inference video.

        Equivalent of the reference's `generate_video`
        (`visualize/visualize_inference.py:72-84`, cv2 VideoWriter over
        saved stills); here frames are (dst, src_uncalib, src_registered)
        tuples rendered via `bev` and written as an animated GIF (PIL —
        no opencv/ffmpeg dependency in the image).
        """
        from PIL import Image
        paths = [self.bev(dst, unc, reg, name=f'{name}_frame_{i:04d}')
                 for i, (dst, unc, reg) in enumerate(frames)]
        images = [Image.open(p).convert('P', palette=Image.ADAPTIVE)
                  for p in paths]
        out = os.path.join(self.out_dir, f'{name}.gif')
        images[0].save(out, save_all=True, append_images=images[1:],
                       duration=int(1000 / fps), loop=0)
        return out
