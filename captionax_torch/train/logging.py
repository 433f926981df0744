"""Metric logging: JSONL always; W&B when the package is importable.

The port's own copy of ``captionax/train/logging.py``.  The reference logs
~10 scalars per step through Lightning's WandbLogger; here the primary
sink is an append-only JSONL file (one record per log call,
``<log_dir>/<run_name>.jsonl``) that W&B or anything else can ingest
later; a live wandb run is used if the package imports and starts.

``wandb.init`` is tried on a thread of its own.  Where it fails (no login,
no network), wandb's error reporter keeps the exception's traceback, and
a traceback keeps every frame below it alive with its locals: on the
caller's thread that would be the CLI's or the trainer's frame, with its
model, gradients and optimizer state, for the rest of the process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional


def _wandb_run(log_dir: str, run_name: str):
    """A wandb run, or None where wandb is missing or does not start."""
    out = []

    def attempt():
        try:
            import wandb

            out.append(wandb.init(project="captionax", name=run_name, dir=log_dir))
        except Exception:
            pass

    t = threading.Thread(target=attempt, daemon=True)
    t.start()
    t.join()
    return out[0] if out else None


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str = "run",
                 use_wandb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = _wandb_run(log_dir, run_name) if use_wandb else None

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
