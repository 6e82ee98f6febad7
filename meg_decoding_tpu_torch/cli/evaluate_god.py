"""GOD evaluation: retrieval, zero-shot classification and pairwise
identification from a checkpoint.  Port of ``_build``, ``predict`` and
``run`` from ``meg_decoding_tpu/cli/evaluate_god.py``.

Reference: ``evaluate.py`` — loads the val split and ``model_best.pt``
(:134-142), scores predictions against the 50-image CLIP gallery
(``zero_shot_classification``, :32-82), and computes pairwise
identification accuracy by correlation and by cosine (:191-261) on
trial-averaged predictions (:182-189).  Writes
``{save_root}/eval_results.json`` with the JAX package's keys: ``val_top1``,
``val_top10``, ``zeroshot_top1``/``zeroshot_top10`` (with
``image_features_path``), ``pairwise_correlation``, ``pairwise_cosine``.

The checkpoint is found as ``cli/evaluate_speech.py`` finds it
(``ckpt_path``, else ``model_best.pt``, ``model_last.pt``, ``model.pt``
under ``{ckpt_dir or save_root/ckpt}``).

With ``error_analysis: true`` it also runs ``cli/eval_analysis.py``
(``eval_wowandb_cv*.py``): ``top5.csv`` (``top5_with_imagenet_val.csv``
when ``imagenet_val_features_path`` names an (N, 512) distractor gallery,
normalized by the train split's Y statistics) and the keys
``similarity_acc``/``mean_acc_scene``.  Its figures (``confusion_mat.png``,
``std_vs_tp.png``) and the top-5 image tiles need matplotlib, and are drawn
only when ``image_dir`` is set (the JAX package draws the figures always);
the machine with the card has no matplotlib.

Run: ``python -m meg_decoding_tpu_torch.cli.evaluate_god
[--config-path configs] [--config-name config_GOD] [--device cuda]
key=value …``
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.cli.evaluate_speech import (
    checkpoint_path,
    collate_config,
    load_model_state,
)
from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.roi import roi
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.objectives.retrieval import (
    pairwise_identification_gallery,
    retrieval_accuracy,
    zero_shot_classification,
)
from meg_decoding_tpu_torch.serving.forward import make_serving_forward

__all__ = ["run", "predict"]


def _build(cfg, dev: torch.device):
    """The train split (for its normalization statistics), the val split
    normalized with them, and the encoder."""
    source = build_god_dataset(cfg, "train", device=dev)
    val = build_god_dataset(cfg, "val", mean_X=source.mean_X, std_X=source.std_X,
                            mean_Y=source.mean_Y, std_Y=source.std_Y, device=dev)
    cfg.num_subjects = source.num_subjects
    roi_channels = roi(cfg)
    model = get_model(cfg, ch_locations_2d(cfg, roi_channels), device=dev,
                      seed=int(cfg.get("seed", 0)),
                      num_channels=len(roi_channels))
    return source, val, model


def predict(cfg, model, dataset, batch_size: int = 256) -> torch.Tensor:
    """The encoder's eval-mode output for every epoch of ``dataset``, with
    the on-device collate chain, in batches of one size: the final batch
    overlaps the one before it (as the JAX package does, to keep one
    compiled shape)."""
    forward = make_serving_forward(collate_config(cfg))
    n = len(dataset)
    bs = min(batch_size, n)
    out = None
    for i in range(0, n, bs):
        start = min(i, n - bs)
        X, _, subs = dataset.gather(np.arange(start, start + bs))[:3]
        z = forward(model, X, subs)
        if out is None:
            out = torch.empty((n,) + tuple(z.shape[1:]), dtype=z.dtype,
                              device=z.device)
        out[start:start + bs] = z
    return out


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    save_root = cfg.get("save_root", "runs_out")
    _, val, model = _build(cfg, dev)
    path = checkpoint_path(cfg)
    model.load_state_dict(load_model_state(path, dev))
    print(f"loaded checkpoint: {path}")

    Z = predict(cfg, model, val)
    Y, labels = val.Y, val.labels
    results = {}
    # retrieval within the val set
    acc = retrieval_accuracy(Z, Y, top_ks=(1, 10))
    results.update({f"val_{k}": float(v) for k, v in acc.items()})

    # zero-shot classification against the (test) gallery if provided
    gallery_path = cfg.get("image_features_path")
    if gallery_path:
        gallery = torch.from_numpy(np.load(gallery_path).astype(np.float32)).to(dev)
        zs = zero_shot_classification(Z, gallery, labels - 1, top_ks=(1, 10))
        results.update({f"zeroshot_{k}": float(v) for k, v in zs.items()})

    # pairwise identification (the headline GOD number, evaluate.py:191-249):
    # trial-averaged predictions per image (evaluate.py:182-189) against the
    # unique per-image gallery (denominator n_images − 1)
    labels_np = labels.cpu().numpy()
    uniq_labels, first_idx = np.unique(labels_np, return_index=True)
    gallery_Y = Y[torch.as_tensor(first_idx, device=dev)]
    Z_avg = torch.stack([Z[torch.as_tensor(labels_np == lab, device=dev)].mean(0)
                         for lab in uniq_labels])
    targets = torch.arange(len(uniq_labels), device=dev)
    for metric in ("correlation", "cosine"):
        pid = pairwise_identification_gallery(Z_avg, gallery_Y, targets,
                                              metric=metric)
        results[f"pairwise_{metric}"] = float(pid.mean())

    if cfg.get("error_analysis", False):
        results.update(_error_analysis(cfg, Z, val, save_root, dev))

    os.makedirs(save_root, exist_ok=True)
    with open(os.path.join(save_root, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


def _error_analysis(cfg, Z, val, save_root: str, dev) -> dict:
    """``eval_analysis.run_error_analysis`` with the ImageNet distractors
    and the image tiles, as JAX ``cli/evaluate_god.py:135-161``."""
    from meg_decoding_tpu_torch.cli.eval_analysis import (
        run_error_analysis,
        save_top5_image_tiles,
    )

    distractors = None
    dpath = cfg.get("imagenet_val_features_path")
    if dpath:
        distractors = np.load(dpath)
    image_dir = cfg.get("image_dir")
    analysis = run_error_analysis(
        Z, val.Y, val.labels, save_root, distractors=distractors,
        norm_mean=val.mean_Y, norm_std=val.std_Y, make_plots=bool(image_dir),
        device=dev)
    if image_dir:
        # run_error_analysis names the CSV by gallery kind
        csv_name = ("top5_with_imagenet_val.csv" if distractors is not None
                    else "top5.csv")
        with open(os.path.join(save_root, csv_name)) as f:
            rows = [{k: int(float(v)) if k != "acc(scene_id)" else float(v)
                     for k, v in r.items() if k}
                    for r in csv.DictReader(f)]
        save_top5_image_tiles(rows, image_dir, save_root)
    return {k: analysis[k] for k in ("similarity_acc", "mean_acc_scene")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-path", default="configs")
    ap.add_argument("--config-name", default="config_GOD")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    cfg = compose(args.config_path, args.config_name, args.overrides)
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
