"""The yardstick's counts against the program's and ``chip_smoke.py``'s."""

import numpy as np
import pytest

from benchcore import counts


def test_step_flops_equal_bench_count_at_speech_widths():
    from meg_decoding_tpu_torch.cli.bench import analytic_step_flops

    for B in (64, 256):
        assert counts.step_flops(B, 208, 360, 270, 320, 1024, 32) == \
            analytic_step_flops(B, 208, 360, 270, 320, 1024, 32)


def test_mean_pooled_form_contracts_f_not_f_times_t():
    seq = counts.step_flops(64, 22, 24, 270, 320, 512, 32, seq2seq=True)
    pooled = counts.step_flops(64, 22, 24, 270, 320, 512, 32, seq2seq=False)
    assert seq - pooled == pytest.approx(3 * 2 * 64 * 64 * 512 * 23)
    assert pooled == pytest.approx(62.5e9, rel=2e-3)


@pytest.mark.parametrize("nbytes, bound_us", [
    # the bounds chip_smoke.py printed at the main paths' shapes (PERF.md
    # §6's table): percentiles of 13,312 rows of 360 and 1,408 of 24;
    # bn_stats and bn_bwd at (64, 320, 360) and (64, 320, 24) f32
    (counts.quantile_bytes(13312, 360), 5.8),
    (counts.quantile_bytes(1408, 24), 0.05),
    (counts.bn_stats_bytes(64 * 320 * 360, 4, 320), 8.8),
    (counts.bn_stats_bytes(64 * 320 * 24, 4, 320), 0.59),
    (counts.bn_bwd_bytes(64 * 320 * 360, 4, 320), 26.4),
    (counts.bn_bwd_bytes(64 * 320 * 24, 4, 320), 1.76),
])
def test_kernel_bytes_match_chip_smoke_bounds(nbytes, bound_us):
    digits = len(str(bound_us).split(".")[1])
    assert round(counts.least_seconds(nbytes) * 1e6, digits) == bound_us


def test_covered_samples_equal_chip_smoke_mask_count():
    """chip_smoke.py counts a gather's reads with a mask over every
    (recording, sample) some window covers; the union of intervals here
    must give the same count, overlapping windows included."""
    rng = np.random.default_rng(0)
    R, L = 4, 360
    T = counts.pad_time_for_gather(3000, L)
    rec = rng.integers(0, R, 64)
    on = rng.integers(0, 3000 - L, 64)
    on[:3] = on[3] + np.array([0, 5, 200])   # overlaps and a repeat
    rec[:3] = rec[3]
    mask = np.zeros(R * T, dtype=bool)
    clamped = np.clip(on, 0, T - counts.padded_window(L))
    for r, o in zip(rec, clamped):
        mask[r * T + o:r * T + o + L] = True
    assert counts.covered_samples(rec, on, L, T) == int(mask.sum())


def test_gather_padding_equals_the_programs():
    from meg_decoding_tpu_torch.ops.kernels import window_gather as wg

    for T, L in ((47040, 360), (3600, 360), (600, 24)):
        assert counts.padded_window(L) == wg.padded_window(L)
        assert counts.pad_time_for_gather(T, L) == wg.pad_time_for_gather(T, L)
