"""The yardstick's arithmetic: the chip's published peaks, the model FLOPs
of a train step, and the bytes each hand-written kernel must move, all
from shapes.  Frozen copies: ``analytic_step_flops`` is
``meg_decoding_tpu_torch/cli/bench.py``'s (itself ``bench.py``'s), the
byte counts are ``chip_smoke.py``'s (each input byte read once, each
output byte written once), and the window-gather clamp bound is
``ops/kernels/window_gather.py``'s."""

from __future__ import annotations

import numpy as np

__all__ = ["PEAKS", "peak_flops", "step_flops", "padded_window",
           "pad_time_for_gather", "covered_samples", "window_gather_bytes",
           "quantile_bytes", "bn_stats_bytes", "bn_bwd_bytes", "least_seconds"]

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {
    "float32": 67e12,     # f32 outside the tensor cores (TF32 is off)
    "bfloat16": 989e12,   # bf16 tensor cores
    "hbm_bytes_per_s": 3.35e12,
}
_LANE = 128


def peak_flops(compute_dtype: str) -> float:
    return PEAKS[compute_dtype]


def step_flops(B: int, C: int, T: int, D1: int, D2: int, F: int, K: int,
               seq2seq: bool = True, num_blocks: int = 5) -> float:
    """Model FLOPs of one train step of the ``BrainEncoder`` with the CLIP
    loss: conv and matmul MACs × 2 for the forward pass, × 3 for forward
    and backward; elementwise work is not counted.  With ``seq2seq`` the
    CLIP logits contract F·T (``cli/bench.py:analytic_step_flops``); the
    mean-pooled encoder (GOD) contracts F."""
    fwd = 0.0
    fwd += 2 * D1 * K * K * C            # spatial-attention map
    fwd += 2 * B * T * D1 * C            # attention apply
    fwd += 2 * B * T * D1 * D1 * 2       # 1x1 conv + per-subject 1x1 conv
    cin = D1
    for _ in range(num_blocks):          # ConvBlocks: k = 3 convs
        fwd += 2 * B * T * D2 * cin * 3
        fwd += 2 * B * T * D2 * D2 * 3
        fwd += 2 * B * T * (2 * D2) * D2 * 3
        cin = D2
    fwd += 2 * B * T * (2 * D2) * D2     # conv_final1 (k = 1)
    fwd += 2 * B * T * F * (2 * D2)      # conv_final2 (k = 1)
    fwd += 2 * B * B * F * (T if seq2seq else 1)  # CLIP logits
    return 3.0 * fwd


def padded_window(length: int) -> int:
    """The gather's aligned fetch size: the smallest multiple of 128 at
    least ``length`` + 127; onsets are clamped to T − this."""
    return ((length + 2 * _LANE - 2) // _LANE) * _LANE


def pad_time_for_gather(T: int, length: int) -> int:
    W = padded_window(length)
    return ((T + W + _LANE - 1) // _LANE) * _LANE


def covered_samples(rec_ids, onsets, length: int, T: int) -> int:
    """Source samples (per channel) that some window covers: the union
    over each recording of [onset, onset + length), onsets clamped as the
    gather clamps them.  Overlapping windows share their reads."""
    rec = np.asarray(rec_ids, dtype=np.int64)
    on = np.clip(np.asarray(onsets, dtype=np.int64), 0,
                 T - padded_window(length))
    total = 0
    for r in np.unique(rec):
        s = np.sort(on[rec == r])
        gaps = np.minimum(np.diff(s), length)
        total += int(gaps.sum()) + length
    return total


def window_gather_bytes(covered: int, C: int, B: int, length: int,
                        out_bytes: int) -> int:
    """Covered source samples read once (f32), the (B, C, length) output
    written once, and the two int32 index vectors."""
    return covered * C * 4 + B * C * length * out_bytes + 2 * B * 4


def quantile_bytes(N: int, T: int) -> int:
    """N rows of T f32 keys read once, three f32 percentiles a row."""
    return N * T * 4 + N * 3 * 4


def bn_stats_bytes(n: int, esize: int, C: int) -> int:
    """x read once, the (2, C) f32 sums written."""
    return n * esize + 2 * C * 4


def bn_bwd_bytes(n: int, esize: int, C: int) -> int:
    """g and x read, dx written; scale, mean and invstd read, the two (C,)
    sums written."""
    return 3 * n * esize + 5 * C * 4


def least_seconds(nbytes: float) -> float:
    """The least time the chip's memory needs to move ``nbytes``."""
    return nbytes / PEAKS["hbm_bytes_per_s"]
