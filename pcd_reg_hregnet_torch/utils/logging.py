"""Metric logging: stdout, CSV and optional wandb (port of
`pcd_reg_hregnet_tpu/utils/logging.py`, the same lines, columns and rows).

One row per epoch: `epoch`, `seconds`, then `train/<metric>` and
`val/<metric>`.  wandb is optional (its import is tried, and skipped with a
line when it fails); the CSV is always written, so runs compare without
external services.  `train/loop.py::fit` and `train/feats_loop.py::fit_feats`
log through it on rank 0, beside their per-step `metrics.jsonl`.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, cfg=None, use_wandb: Optional[bool] = None,
                 trim_from_epoch: Optional[int] = None):
        self.log_dir = log_dir
        # on preemption resume: drop prior rows with epoch >= this value so
        # the csv keeps exactly one row per epoch (replayed epochs rewrite)
        self.trim_from_epoch = trim_from_epoch
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, 'metrics.csv')
        self._csv_file = None
        self._writer = None
        self.wandb = None
        use_wandb = (cfg.train.use_wandb if (use_wandb is None and cfg is not None)
                     else bool(use_wandb))
        if use_wandb:
            try:
                import wandb
                run_name = (cfg.train.runname or None) if cfg else None
                self.wandb = wandb.init(project='pcd_reg_hregnet_torch',
                                        name=run_name, config=json.loads(cfg.to_json())
                                        if cfg else None)
            except Exception as e:  # no network / not installed: CSV only
                print(f'[logger] wandb unavailable ({e}); logging to CSV only')
        if cfg is not None:
            with open(os.path.join(log_dir, 'config.json'), 'w') as f:
                f.write(cfg.to_json())

    def log_epoch(self, epoch: int, train_metrics: Dict[str, float],
                  val_metrics: Dict[str, float], seconds: float = 0.0) -> None:
        row = {'epoch': epoch, 'seconds': round(seconds, 2)}
        row.update({f'train/{k}': v for k, v in train_metrics.items()})
        row.update({f'val/{k}': v for k, v in val_metrics.items()})
        if self._writer is None:
            # Append across relaunches (preemption resume keeps one
            # continuous history).  When an existing file's header differs
            # (e.g. val_every > 1 means the first fresh row has no val/*
            # columns while a resumed run's does), append under the UNION of
            # both field sets and rewrite the header line — never truncate
            # prior history (ADVICE r2: exact-match 'w' mode silently wiped
            # the old csv).
            fields = list(row)
            append, old_rows = False, []
            if os.path.exists(self.csv_path):
                with open(self.csv_path, newline='') as f:
                    header = f.readline().strip()
                append = (header == ','.join(fields)
                          and self.trim_from_epoch is None)
                if not append and header:
                    old_fields = header.split(',')
                    fields = old_fields + [k for k in fields
                                           if k not in old_fields]
                    with open(self.csv_path, newline='') as f:
                        old_rows = list(csv.DictReader(f))
                    if self.trim_from_epoch is not None:
                        old_rows = [
                            r for r in old_rows if r.get('epoch')
                            and int(float(r['epoch'])) < self.trim_from_epoch]
            self._csv_file = open(self.csv_path, 'a' if append else 'w',
                                  newline='')
            self._writer = csv.DictWriter(self._csv_file, fieldnames=fields)
            if not append:
                self._writer.writeheader()
                for r in old_rows:   # preserved history under the new header
                    self._writer.writerow({k: r.get(k, '') for k in fields})
        self._writer.writerow({k: row.get(k, '') for k in self._writer.fieldnames})
        self._csv_file.flush()
        if self.wandb is not None:
            self.wandb.log(row, step=epoch)
        headline = {k: row.get(f'val/{k}', row.get(f'train/{k}'))
                    for k in ('loss', 'rre', 'rte')}
        parts = ', '.join(f'{k}={v:.4f}' for k, v in headline.items()
                          if isinstance(v, float))
        print(f'[epoch {epoch:4d}] {parts}  ({seconds:.1f}s)')

    def close(self) -> None:
        if self._csv_file:
            self._csv_file.close()
        if self.wandb is not None:
            self.wandb.finish()
