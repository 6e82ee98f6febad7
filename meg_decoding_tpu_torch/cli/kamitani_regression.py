"""Kamitani-lab classical baseline: SLiR feature prediction on GOD MEG.
Port of ``examples/kamitani_regression.py`` (its ``run``).

Reference: ``examples/kamitani_regression.py`` (``run_meg_fit_and_evaluate``
:215-255): load the train and val GOD epochs → SCP (the time-mean) →
per-unit voxel selection + SLiR regression → category-averaged pairwise
identification accuracy.  The GOD sets are built on ``device``
(``data/god.py``) and every unit fits at once there
(``kamitani/pipeline.py``).  Writes
``{save_root}/kamitani_regression.json`` = ``{"acc": …, "category_wise":
{label: rate}}``, as the JAX example does.

Run: ``python -m meg_decoding_tpu_torch.cli.kamitani_regression
[--config-path configs] [--config-name config_GOD] [--device cuda]
key=value …`` (``ch_ratios``, ``slir_n_iter``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.core.config import compose
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.kamitani.pipeline import (
    feature_prediction,
    get_averaged_feature,
    pairwise_identification_rate,
)

__all__ = ["run", "main"]


def run(cfg, ch_ratios: float = 1.0, n_iter: int = 200, manual_ch=None,
        onsets=None, device: str | torch.device = "cuda"):
    """Fit and score; returns ``(acc, category_wise)``.  ``manual_ch``:
    explicit 0-indexed channels; ``onsets``: region → onset seconds
    (``build_god_dataset``)."""
    dev = resolve_device(device)
    train = build_god_dataset(cfg, "train", manual_ch=manual_ch, onsets=onsets,
                              device=dev)
    test = build_god_dataset(cfg, "val", manual_ch=manual_ch, onsets=onsets,
                             device=dev)

    # SCP: mean over the time window (reference :226-228)
    train_X = train.X.mean(-1).cpu().numpy()
    test_X = test.X.mean(-1).cpu().numpy()
    train_Y = train.Y.cpu().numpy()
    test_Y = test.Y.cpu().numpy()
    test_label = test.labels.cpu().numpy()

    n_voxel = max(int(ch_ratios * train_X.shape[1]), 1)
    pred_y, true_y = feature_prediction(train_X, train_Y, test_X, test_Y,
                                        n_voxel=n_voxel, n_iter=n_iter,
                                        device=dev)

    pred_avg, true_avg, label_set = get_averaged_feature(pred_y, true_y, test_label)
    rates = pairwise_identification_rate(pred_avg, true_avg, device=dev)
    acc = float(np.mean(rates))
    cat_wise = {int(k): float(v) for k, v in zip(label_set, rates)}
    print("ACC from binary corr", acc)

    save_root = cfg.get("save_root", "runs_out")
    os.makedirs(save_root, exist_ok=True)
    with open(os.path.join(save_root, "kamitani_regression.json"), "w") as f:
        json.dump({"acc": acc, "category_wise": cat_wise}, f, indent=2)
    return acc, cat_wise


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-path", default="configs")
    ap.add_argument("--config-name", default="config_GOD")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    cfg = compose(args.config_path, args.config_name, args.overrides)
    return run(cfg, ch_ratios=float(cfg.get("ch_ratios", 1.0)),
               n_iter=int(cfg.get("slir_n_iter", 200)), device=args.device)


if __name__ == "__main__":
    main()
