"""Kamitani feature-prediction pipeline, batched over the image-feature
units.  Port of ``meg_decoding_tpu/kamitani/pipeline.py`` (``:27-96``).

Reference: ``examples/kamitani_regression.py`` — per-unit Python loop
(:531-618): normalize x/y, select the top-n voxels by |corr| with the
unit, add a bias, SLiR fit/predict, denormalize; then category-averaged
pairwise identification (:163-213, ``get_averaged_feature`` :621-629).

All units fit at once on ``device``: the voxel selection is one
correlation matmul and a gather, and the 200 ARD iterations of every unit
run as batched matmuls and pseudo-inverses (``kamitani/slir.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.kamitani.helpers import corrmat
from meg_decoding_tpu_torch.kamitani.slir import slir_fit, slir_predict

__all__ = ["feature_prediction", "get_averaged_feature",
           "pairwise_identification_rate"]


def feature_prediction(x_train, y_train, x_test, y_test, n_voxel: int = 500,
                       n_iter: int = 200, device: str | torch.device = "cuda",
                       return_fit: bool = False):
    """Predict every image-feature unit from brain data.

    x_*: (N, V) brain features; y_*: (N, U) image features.  Returns
    ``(y_predicted (N_test, U), y_true (N_test, U))`` as numpy; with
    ``return_fit`` also the fit ``(W, A, SY, mask)`` of every unit (numpy,
    units first)."""
    dev = resolve_device(device)
    x_train = np.asarray(x_train, np.float64)
    x_test = np.asarray(x_test, np.float64)
    y_train = np.asarray(y_train, np.float64)
    y_test = np.asarray(y_test, np.float64)
    n_voxel = min(n_voxel, x_train.shape[1])

    # normalize brain data with train stats (:553-558)
    mx = x_train.mean(0)
    sx = x_train.std(0, ddof=1)
    sx = np.where(sx == 0, 1.0, sx)
    xtr = (x_train - mx) / sx
    xte = (x_test - mx) / sx

    # normalize each feature unit (:576-581)
    my = y_train.mean(0)
    sy = y_train.std(0, ddof=1)
    sy = np.where(sy == 0, 1.0, sy)
    ytr = (y_train - my) / sy  # (N, U)

    # per-unit voxel selection by |corr| (:584-588): one corr matmul
    C = np.abs(corrmat(ytr.T, xtr.T, device=dev))  # (U, V)
    C = np.where(np.isnan(C), -np.inf, C)
    top_idx = np.argsort(-C, axis=1)[:, :n_voxel]  # (U, n_voxel)

    # per-unit design matrices + a bias column, units first
    def design(x):
        xs = np.transpose(x[:, top_idx], (1, 0, 2))  # (U, N, n_voxel)
        ones = np.ones((*xs.shape[:2], 1))
        return np.concatenate([xs, ones], -1).astype(np.float32)

    W, A, SY, mask = slir_fit(design(xtr), ytr.T[:, :, None].astype(np.float32),
                              n_iter=n_iter, device=dev)
    preds = slir_predict(W, design(xte))         # (U, N_test, 1)
    y_pred = preds[:, :, 0].T.cpu().numpy()      # (N_test, U)

    # denormalize (:607)
    y_pred = y_pred * sy + my
    if return_fit:
        fit = tuple(t.cpu().numpy() for t in (W, A, SY, mask))
        return y_pred, y_test, fit
    return y_pred, y_test


def get_averaged_feature(pred_y, true_y, labels):
    """Category-averaged features (reference :621-629)."""
    labels = np.asarray(labels)
    labels_set = np.unique(labels)
    pred_av = np.stack([pred_y[labels == c].mean(0) for c in labels_set])
    true_av = np.stack([true_y[labels == c].mean(0) for c in labels_set])
    return pred_av, true_av, labels_set


def pairwise_identification_rate(pred, candidates,
                                 device: str | torch.device = "cuda"):
    """Pairwise identification correct rate per prediction (reference
    ``get_pwident_correctrate`` :191-213): for prediction i, the fraction of
    candidates j ≠ i whose correlation with pred_i does not exceed that of
    the true candidate i."""
    simmat = corrmat(np.asarray(pred), np.asarray(candidates), device=device)
    P, C = simmat.shape
    correct = np.diagonal(simmat)[:, None]
    wins = np.sum(simmat > correct, axis=1)
    return (C - 1 - wins) / float(C - 1)
