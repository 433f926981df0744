"""Metric logging: JSONL always; W&B when the package is importable.

The port's own copy of ``captionax/train/logging.py``.  The reference logs
~10 scalars per step through Lightning's WandbLogger; here the primary
sink is an append-only JSONL file (one record per log call,
``<log_dir>/<run_name>.jsonl``) that W&B or anything else can ingest
later; a live wandb run is used if the package imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run",
                 use_wandb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project="captionax", name=run_name, dir=log_dir
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
