"""Retrieval error analysis: confusion matrices, FP/TP rates, top-5 CSV,
ImageNet-val distractor galleries.  Port of
``meg_decoding_tpu/cli/eval_analysis.py``.

Reference: ``eval_wowandb_cv.py`` — Z double-standardization (:301-304),
binary pairwise confusion matrix + similarity accuracy (:391-406), seaborn
heatmap (:408-415), FP/TP-rate box plots (:318-340), std-vs-TP scatter
(:348-352), top-5 CSV with per-query accuracy (:352-366);
``eval_wowandb_cv_imagenet_val.py`` — the same scored against a gallery
extended with 50k ImageNet-val CLIP vectors normalized by train stats
(:149-160, 366-391).

The similarity matrix is one matmul on ``device`` (the reference fills it
with an O(B·G) Python loop); the rest is numpy on the host, as in the JAX
package.  matplotlib is imported only by the figures (``make_plots``) and
the image tiles (``save_top5_image_tiles``).
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.objectives.retrieval import cosine_similarity_matrix

__all__ = [
    "double_standardize",
    "binary_confusion",
    "fp_tp_rates",
    "top5_table",
    "extend_gallery",
    "save_top5_image_tiles",
    "run_error_analysis",
]


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def double_standardize(Z) -> np.ndarray:
    """Column- then row-standardize predictions (eval_wowandb_cv.py:301-304)."""
    Z = _numpy(Z).astype(np.float64)
    Z = (Z - Z.mean(0, keepdims=True)) / Z.std(0, keepdims=True)
    Z = (Z - Z.mean(1, keepdims=True)) / Z.std(1, keepdims=True)
    return Z


def binary_confusion(Z, Y, device: str | torch.device = "cpu"):
    """(acc, mat, sim): mat[i, j] = +1 where sim(i,i) beats sim(i,j), −1
    where it loses, 0 on ties/diagonal (reference ``evaluate`` :391-406);
    the f32 cosine similarities computed on ``device``."""
    as_f32 = lambda a: torch.as_tensor(_numpy(a), dtype=torch.float32,
                                       device=device)
    sim = cosine_similarity_matrix(as_f32(Z), as_f32(Y)).cpu().numpy()
    diag = np.diagonal(sim)[:, None]
    mat = np.zeros_like(sim)
    mat[sim < diag] = 1.0
    mat[sim > diag] = -1.0
    acc = float(np.mean(np.sum(sim < diag, axis=1) / (sim.shape[1] - 1)))
    return acc, mat, sim


def fp_tp_rates(mat: np.ndarray):
    """miss-detection (FP) per database item and true-detection (TP) per
    query (reference :312-317)."""
    n = len(mat)
    fp = np.sum(mat < 0, axis=0) / (n - 1)
    tp = np.sum(mat > 0, axis=1) / (n - 1)
    return fp, tp


def top5_table(sim: np.ndarray, labels, mat: np.ndarray):
    """Rows of the reference's top5.csv (:352-366): per query, its label,
    per-query accuracy, and the 5 most-similar gallery ids (1-indexed)."""
    acc_per_sample = np.round((mat > 0).sum(axis=1) / (sim.shape[1] - 1), 3)
    rows = []
    for i, lab in enumerate(_numpy(labels)):
        ranking = np.argsort(sim[i])[::-1][:5] + 1
        rows.append({
            "query_image_id": int(lab),
            "acc(scene_id)": float(acc_per_sample[i]),
            **{f"top{k}_image_id": int(ranking[k - 1]) for k in range(1, 6)},
        })
    return rows


def extend_gallery(Y, distractors, norm_mean=None, norm_std=None) -> np.ndarray:
    """Append distractor features (e.g. 50k ImageNet-val CLIP vectors),
    normalized by the train-set stats when given
    (eval_wowandb_cv_imagenet_val.py:149-160)."""
    d = _numpy(distractors).astype(np.float32)
    if norm_mean is not None:
        d = (d - _numpy(norm_mean)) / _numpy(norm_std)
    return np.concatenate([_numpy(Y).astype(np.float32), d], axis=0)


def save_top5_image_tiles(rows, image_dir: str, save_root: str,
                          max_queries: int = 20):
    """Dump a tile figure per query: the query image + its top-5 predictions
    (reference eval_wowandb_cv_imagenet_val.py:396-422).  ``image_dir`` maps
    1-indexed gallery ids to files named ``<id>.*``."""
    import glob

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.image import imread

    def _find(img_id):
        hits = glob.glob(os.path.join(image_dir, f"{img_id}.*"))
        return hits[0] if hits else None

    out_dir = os.path.join(save_root, "top5_tiles")
    os.makedirs(out_dir, exist_ok=True)
    for r in rows[:max_queries]:
        ids = [r["query_image_id"]] + [r[f"top{k}_image_id"] for k in range(1, 6)]
        fig, axes = plt.subplots(1, 6, figsize=(18, 3))
        for ax, img_id, title in zip(
            axes, ids, ["query"] + [f"top{k}" for k in range(1, 6)]
        ):
            path = _find(img_id)
            if path:
                ax.imshow(imread(path))
            ax.set_title(f"{title} (id {img_id})")
            ax.axis("off")
        plt.savefig(os.path.join(out_dir, f"query_{r['query_image_id']}.png"),
                    bbox_inches="tight")
        plt.close()
    return out_dir


def _save_figures(mat, Z, tp, acc, n, save_root):
    """confusion_mat.png and std_vs_tp.png, as the reference draws them."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns

        sns.heatmap(mat[:, :n], square=True, annot=False)
    except ImportError:
        plt.imshow(mat[:, :n], aspect="equal")
        plt.colorbar()
    plt.xlabel("database data")
    plt.ylabel("query data")
    plt.title(f"similarity acc: {acc}")
    plt.savefig(os.path.join(save_root, "confusion_mat.png"))
    plt.close()

    plt.scatter(Z.std(axis=1), tp)
    plt.xlabel("std of Z")
    plt.ylabel("TP ratio")
    plt.savefig(os.path.join(save_root, "std_vs_tp.png"), bbox_inches="tight")
    plt.close()


def run_error_analysis(Z, Y, labels, save_root: str,
                       distractors=None, norm_mean=None, norm_std=None,
                       standardize: bool = True, make_plots: bool = True,
                       device: str | torch.device = "cpu") -> dict:
    """Full analysis pass; writes top5.csv (``top5_with_imagenet_val.csv``
    with distractors) and, with ``make_plots``, confusion_mat.png and
    std_vs_tp.png (names match the reference artifacts under ``tmps/``)."""
    os.makedirs(save_root, exist_ok=True)
    Z = double_standardize(Z) if standardize else _numpy(Z).astype(np.float64)
    gallery = _numpy(Y).astype(np.float32)
    if distractors is not None:
        gallery = extend_gallery(gallery, distractors, norm_mean, norm_std)

    acc, mat, sim = binary_confusion(Z, gallery, device=device)
    fp, tp = fp_tp_rates(mat[:, : len(Z)])  # rates over the paired block

    rows = top5_table(sim, labels, mat)
    csv_name = "top5.csv" if distractors is None else "top5_with_imagenet_val.csv"
    with open(os.path.join(save_root, csv_name), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["", *rows[0].keys()])
        writer.writeheader()
        for i, r in enumerate(rows):
            writer.writerow({"": i, **r})

    bias = np.abs(mat[: len(Z), : len(Z)] - mat[: len(Z), : len(Z)].T)
    tril = np.tril(np.ones_like(bias), k=-1) > 0
    biased = int(np.sum((bias == 2) & tril))
    fair = int(np.sum((bias == 0) & tril))

    if make_plots:
        _save_figures(mat, Z, tp, acc, len(Z), save_root)

    return {
        "similarity_acc": acc,
        "mean_acc_scene": float(np.mean([r["acc(scene_id)"] for r in rows])),
        "fp_rates": fp.tolist(),
        "tp_rates": tp.tolist(),
        "biased_judgements": biased,
        "fair_judgements": fair,
    }
