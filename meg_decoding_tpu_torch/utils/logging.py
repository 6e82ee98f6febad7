"""Run logging: console epoch summaries + JSONL metric history.
Port of ``meg_decoding_tpu/utils/logging.py`` without wandb.

Reference: ``meg_decoding/utils/loggers.py`` (the whole metric history
re-pickled each epoch) plus console prints (``train.py:247-255``).  Here:
append-only JSONL under ``{save_root}/runs/<run_name or timestamp>/``
with the same metric names, and the composed config beside it.
"""

from __future__ import annotations

import json
import os
import time

import yaml

from meg_decoding_tpu_torch.core.config import to_dict

__all__ = ["RunLogger"]


class RunLogger:
    def __init__(self, save_root: str, run_name: str | None = None):
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = os.path.join(save_root, "runs", run_name or ts)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, "metrics.jsonl")

    def dump_config(self, cfg) -> str:
        """Write the composed run config as ``config.yaml`` in the run
        directory (the reference's runs carry ``.hydra/config.yaml``), so
        the eval CLI can rebuild exactly the trained model."""
        path = os.path.join(self.run_dir, "config.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
        return path

    def log(self, metrics: dict) -> None:
        metrics = {k: (float(v) if hasattr(v, "__float__") else v)
                   for k, v in metrics.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")

    def summary(self, epoch: int, epochs: int, metrics: dict) -> None:
        parts = [f"Ep {epoch}/{epochs}"]
        for k, v in metrics.items():
            if k == "epoch":
                continue
            parts.append(f"{k}: {float(v):.4f}" if hasattr(v, "__float__")
                         else f"{k}: {v}")
        print(" | ".join(parts), flush=True)
