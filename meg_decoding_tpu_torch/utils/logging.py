"""Run logging: console epoch summaries + JSONL metric history, and wandb
when it is asked for and available.  Port of
``meg_decoding_tpu/utils/logging.py``.

Reference: ``meg_decoding/utils/loggers.py`` (the whole metric history
re-pickled each epoch) plus console prints (``train.py:247-255``) and
optional wandb (``train.py:257-269``).  Here: append-only JSONL under
``{save_root}/runs/<run_name or timestamp>/`` with the same metric names,
and the composed config beside it.  With ``use_wandb`` the logger also
logs to wandb; ``wandb`` is imported only then, and a missing module or
a failed ``wandb.init`` (no credentials, offline) leaves the JSONL alone.
"""

from __future__ import annotations

import json
import os
import time

import yaml

from meg_decoding_tpu_torch.core.config import to_dict

__all__ = ["RunLogger"]


class RunLogger:
    def __init__(self, save_root: str, run_name: str | None = None,
                 use_wandb: bool = False, wandb_cfg=None):
        ts = time.strftime("%Y%m%d-%H%M%S")
        self.run_dir = os.path.join(save_root, "runs", run_name or ts)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=getattr(wandb_cfg, "project", None),
                           entity=getattr(wandb_cfg, "entity", None),
                           name=getattr(wandb_cfg, "run_name", None))
                # set only after init succeeded: a failed init must leave
                # it unset, or every log() would fail
                self._wandb = wandb
            except Exception as e:  # noqa: BLE001  missing module, credentials
                print(f"[logger] wandb unavailable ({e}); falling back to "
                      "JSONL only")

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
        if self._wandb is not None:
            self._wandb.log(metrics)

    def summary(self, epoch: int, epochs: int, metrics: dict) -> None:
        parts = [f"Ep {epoch}/{epochs}"]
        for k, v in metrics.items():
            if k == "epoch":
                continue
            parts.append(f"{k}: {float(v):.4f}" if hasattr(v, "__float__")
                         else f"{k}: {v}")
        print(" | ".join(parts), flush=True)
