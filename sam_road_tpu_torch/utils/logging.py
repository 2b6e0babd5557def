"""Metrics logging (counterpart of sam_road_tpu/utils/logging.py): one JSON
line per record in <output_dir>/metrics.jsonl, wandb as well when asked for
and installed; `disabled` writes nothing."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, output_dir: str, project: str = "sam_road_tpu",
                 config=None, use_wandb: bool = False, disabled: bool = False):
        self.disabled = disabled
        self.path = os.path.join(output_dir, "metrics.jsonl")
        os.makedirs(output_dir, exist_ok=True)
        self._wandb = None
        if use_wandb and not disabled:
            try:
                import wandb
            except ImportError:
                print("wandb not available; logging to JSONL only")
            else:
                wandb.init(project=project, config=dict(config) if config else None)
                self._wandb = wandb

    def log(self, metrics: dict, step: int | None = None):
        if self.disabled:
            return
        record = {"ts": time.time(), **metrics}
        if step is not None:
            record["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, key: str, paths, step: int | None = None):
        """Record image files: their paths in the JSONL, wandb.Image where
        wandb is active."""
        if self.disabled:
            return
        self.log({key: list(paths)}, step=step)
        if self._wandb is not None:
            self._wandb.log({key: [self._wandb.Image(p) for p in paths]}, step=step)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
