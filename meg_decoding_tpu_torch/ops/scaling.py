"""Robust scaling, clamping and baseline correction — the batch-time collate
chain — and the GOD epoching gather.  Port of
``meg_decoding_tpu/ops/scaling.py``.

Reference semantics:
* ``scaleAndClamp`` (``preproc_utils.py:69-105``): sklearn ``RobustScaler``
  fit per sample — center by the per-channel **median** over time, scale by
  the per-channel **IQR** (25–75th percentiles), then clamp to ±clamp_lim.
* ``baseline_correction_single`` (``preproc_utils.py:128-142``): subtract
  the per-channel mean of the first ``baseline_len_samp`` samples.

The percentiles come from ``ops/kernels/quantile.py``: the hand-written
CUDA kernel for a CUDA tensor, its sort-based plain version for a CPU
tensor, both through the registered custom op
``meg_decoding_tpu_torch::robust_quantiles``, which a ``torch.export``
trace keeps.  (The JAX package's default is an XLA sort; on the card a
``torch.sort`` would be a library call on the main path.)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fnn

from meg_decoding_tpu_torch.ops.kernels.quantile import robust_quantiles
from meg_decoding_tpu_torch.ops.kernels.window_gather import (
    pad_time_for_gather,
    window_gather,
)

__all__ = [
    "robust_scale",
    "robust_stats",
    "apply_robust_stats",
    "scale_and_clamp",
    "baseline_correct",
    "epoch_slice",
    "collate_preprocess",
    "collate_preprocess_cached",
]


def _percentile_sorted(xs: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated percentile along the last axis of pre-sorted data
    (numpy 'linear' method — what sklearn RobustScaler uses)."""
    n = xs.shape[-1]
    pos = q / 100.0 * (n - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return xs[..., lo] * (1 - frac) + xs[..., hi] * frac


def robust_stats(x: torch.Tensor, axis: int = -1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slice RobustScaler fit along ``axis``: returns ``(median, iqr)``
    with sklearn's near-zero-IQR fallback applied (``iqr < 10·eps`` → 1.0,
    ``_handle_zeros_in_scale``).  ``x`` must be float32."""
    x_moved = x.movedim(axis, -1)
    lead = x_moved.shape[:-1]
    qs = robust_quantiles(x_moved.reshape(-1, x_moved.shape[-1]).contiguous())
    q25 = qs[:, 0].reshape(lead)
    med = qs[:, 1].reshape(lead)
    q75 = qs[:, 2].reshape(lead)
    iqr = q75 - q25
    iqr = torch.where(iqr < 10 * torch.finfo(x.dtype).eps,
                      torch.ones_like(iqr), iqr)
    return med, iqr


def apply_robust_stats(x: torch.Tensor, med: torch.Tensor, iqr: torch.Tensor,
                       axis: int = -1) -> torch.Tensor:
    """``(x − med) / iqr`` broadcast along ``axis`` — subtract, then true
    divide, exactly as the inline path does."""
    x_moved = x.movedim(axis, -1)
    scaled = (x_moved - med[..., None]) / iqr[..., None]
    return scaled.movedim(-1, axis)


def robust_scale(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """(x − median) / IQR along ``axis`` (RobustScaler fit + transform)."""
    med, iqr = robust_stats(x, axis=axis)
    return apply_robust_stats(x, med, iqr, axis=axis)


def scale_and_clamp(X: torch.Tensor, clamp_lim: float,
                    clamp: bool = True) -> torch.Tensor:
    """Per-sample, per-channel robust scale over time + clamp.  X: (..., C, T)."""
    out = robust_scale(X, axis=-1)
    if clamp:
        out = out.clamp(-clamp_lim, clamp_lim)
    return out


def baseline_correct(X: torch.Tensor, baseline_len_samp: int) -> torch.Tensor:
    """Subtract the mean of the first ``baseline_len_samp`` samples, per
    channel per chunk.  X: (..., C, T)."""
    return X - X[..., :baseline_len_samp].mean(dim=-1, keepdim=True)


def epoch_slice(x: torch.Tensor, onsets, length: int) -> torch.Tensor:
    """Fixed-length windows of one recording: x (C, T) f32, onsets (N,) →
    (N, C, length), as the JAX package's TPU branch cuts them
    (``ops/scaling.py:150-162``): onsets clamped to [0, max(T − length, 0)]
    (a window overhanging the end shifts left into range), the time axis
    padded to ``pad_time_for_gather(T, length)``, then one ``window_gather``
    call — the CUDA kernel on the card, its plain version on the CPU.  The
    pre-clamp keeps every onset under the gather's own clamp bound,
    Tp − padded_window(length) ≥ T, so both clamps give the windows the
    JAX package's CPU branch takes."""
    T = x.shape[-1]
    onsets = torch.as_tensor(onsets, device=x.device).to(torch.int32)
    onsets = onsets.clamp(0, max(T - length, 0))
    xp = Fnn.pad(x, (0, pad_time_for_gather(T, length) - T))[None]
    rec_ids = torch.zeros_like(onsets)
    return window_gather(xp, rec_ids, onsets, length)


def collate_preprocess(X: torch.Tensor, baseline_len_samp: int,
                       clamp_lim: float, clamp: bool = True) -> torch.Tensor:
    """The collate: baseline correction → robust scale → clamp.  X: (B, C, T)
    (replaces the reference's per-batch host sklearn refit,
    ``gwilliams2022.py:641-662``)."""
    if baseline_len_samp > 0:
        X = baseline_correct(X, baseline_len_samp)
    return scale_and_clamp(X, clamp_lim, clamp)


def collate_preprocess_cached(X: torch.Tensor, med: torch.Tensor,
                              iqr: torch.Tensor, baseline_len_samp: int,
                              clamp_lim: float, clamp: bool = True
                              ) -> torch.Tensor:
    """``collate_preprocess`` with PRE-COMPUTED robust-scale stats
    (``robust_stats`` of the baseline-corrected window).  X: (B, C, T);
    med/iqr: (B, C)."""
    if baseline_len_samp > 0:
        X = baseline_correct(X, baseline_len_samp)
    out = apply_robust_stats(X, med, iqr, axis=-1)
    if clamp:
        out = out.clamp(-clamp_lim, clamp_lim)
    return out
