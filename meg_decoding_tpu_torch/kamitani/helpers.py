"""Kamitani-lab helpers: bias terms, feature selection, correlation.
Port of ``meg_decoding_tpu/kamitani/helpers.py`` (``:17-72``).

Reference: ``meg_decoding/kamitani_lab/`` (bdpy ports) — ``add_bias``
(ml.py:13-36), ``select_top`` (preproc.py:13-54), ``corrcoef``/``corrmat``
(stats.py:13-110).  ``corrmat`` is one f32 matmul on ``device``; the rest
is numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device

__all__ = ["add_bias", "select_top", "corrcoef", "corrmat"]


def add_bias(x, axis: int = 0):
    """Append a row (axis=0) or column (axis=1) of ones."""
    x = np.asarray(x)
    if axis == 0:
        return np.concatenate([x, np.ones((1, x.shape[1]))], axis=0)
    if axis == 1:
        return np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
    raise ValueError("axis should be either 0 or 1")


def select_top(data, value, num: int, axis: int = 0):
    """Select the ``num`` features with the largest ``value`` (NaNs last),
    preserving original order.  Returns (selected_data, selected_index)."""
    data = np.asarray(data)
    value = np.where(np.isnan(value), -np.inf, np.asarray(value, float))
    order = np.argsort(value)[::-1]
    rank = np.empty(len(value), dtype=int)
    rank[order] = np.arange(len(value))
    keep = rank < num
    idx = np.arange(data.shape[axis])[keep]
    return (data[keep] if axis == 0 else data[:, keep]), idx


def corrcoef(x, y, var: str = "row"):
    """Row-wise (or column-wise) correlation between paired variables."""
    x = np.atleast_2d(np.asarray(x, float))
    y = np.atleast_2d(np.asarray(y, float))
    if var == "col":
        x, y = x.T, y.T
    elif var != "row":
        raise ValueError("var must be 'row' or 'col'")
    if x.shape[0] == 1 and y.shape[0] != 1:
        x = np.repeat(x, y.shape[0], axis=0)
    elif y.shape[0] == 1 and x.shape[0] != 1:
        y = np.repeat(y, x.shape[0], axis=0)
    xc = x - x.mean(axis=1, keepdims=True)
    yc = y - y.mean(axis=1, keepdims=True)
    denom = np.linalg.norm(xc, axis=1) * np.linalg.norm(yc, axis=1)
    denom = np.where(denom == 0, 1.0, denom)
    return np.sum(xc * yc, axis=1) / denom


def corrmat(x, y, var: str = "row", device: str | torch.device = "cuda"):
    """Full correlation matrix between the variables of x and those of y:
    one f32 matmul on ``device`` (reference stats.py:80-110).  Returns
    numpy."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev)
    if var == "col":
        x, y = x.T, y.T
    nobs = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    cov = (xc @ yc.T) / (nobs - 1)
    sx = x.std(dim=1, unbiased=True)
    sy = y.std(dim=1, unbiased=True)
    return (cov / torch.outer(sx, sy)).cpu().numpy()
