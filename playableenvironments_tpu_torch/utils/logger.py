"""Experiment logging: JSONL on disk, wandb when available.

Port of playableenvironments_tpu/utils/logger.py: metrics stream to
`<output_dir>/metrics.jsonl` (one JSON object a call, with `step` and
`time`), messages to `<output_dir>/log.txt`, images to
`<output_dir>/images/<step>_<name>.png`; a wandb run mirrors them where the
package is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class Logger:
    def __init__(self, output_dir: str, run_name: str = "run", use_wandb: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        os.makedirs(os.path.join(output_dir, "images"), exist_ok=True)
        self._metrics_file = open(os.path.join(output_dir, "metrics.jsonl"), "a", buffering=1)
        self._log_file = open(os.path.join(output_dir, "log.txt"), "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="playableenvironments_tpu", name=run_name, dir=output_dir)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, image: np.ndarray, step: int):
        """:param image: (H, W, 3) float in [0, 1]."""
        from PIL import Image

        path = os.path.join(self.output_dir, "images", f"{step:08}_{name}.png")
        Image.fromarray(np.clip(np.asarray(image) * 255, 0, 255).astype(np.uint8)).save(path)
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(path)}, step=step)

    def print(self, message: str):
        print(message, flush=True)
        self._log_file.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {message}\n")

    def close(self):
        self._metrics_file.close()
        self._log_file.close()
        if self._wandb is not None:
            self._wandb.finish()
