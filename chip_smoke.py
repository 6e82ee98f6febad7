#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (meg_decoding_tpu_torch).

Drives the port's Gwilliams2022 serving and eval path, its training
path, the speed presets and the whole-epoch forms on one NVIDIA GPU at the
full width of the speech model in
``configs/config.yaml`` (C = 208, D1 = 270, D2 = 320, F = 1024, K = 32,
5 ConvBlocks, seq2seq, T = 360, 27 subjects, batch 64, f32), then the GOD
image workload's data build, train and eval path at the full width of
``configs/config_GOD.yaml`` (22 ROI channels, D1 = 270, D2 = 320, F = 512,
mean-pooled, T = 24, batch 64, f32) with the brain encoder, EEGNet and
Seq2Static, then Brennan2018 (EEG ↔ audiobook) at the scale of the real
dataset and the full width of ``configs/config.yaml`` (60 channels on the
easycap layout, S = 33, F = 1024, T = 360, batch 64, f32, no batch-time
collate), then the stimulus encoders at full width (wav2vec2-large-xlsr-53
and CLIP ViT-B/32), the Gwilliams preprocessing and cache builder, GOD's
error analysis and the dispatching entry points, then the serving artifact
(``torch.export`` with the percentiles as the registered custom op), the
export CLI, the reference-checkpoint import and the host-spill training
path, with random weights from ``--seed``.
Phases, each printed as one JSON line:

1. build    — compile the three CUDA sources of
              ``meg_decoding_tpu_torch/csrc`` (window_gather,
              robust_quantiles, batchnorm_stats; one nvcc per source, in
              parallel);
2. device   — the card's name and power limit, as nvidia-smi reports them;
3. kernels  — each of the four kernels against its plain PyTorch version
              on the card at the main path's shapes (gather bit-exact,
              percentiles ≤ 1 ulp, BN sums within 1e-5 of the sum of
              magnitudes per channel, the BN backward's dx within the bound
              those sums carry to it, plus one bf16 ulp in bf16; every BN
              result bit-identical across two launches), and off those
              shapes, with CUDA-event times (median of 30, L2 flushed
              before each) of the kernel, the plain version and one PyTorch
              library call where there is one, and the kernel's device time
              per call in a run of 64 back-to-back calls on inputs cold in
              the L2 (``run_ms``).  The Pallas ``bn_bwd_stats`` row is the
              train path's kernel, ``bn_bwd`` (sums and dx in one launch);
              its sums alone (``bn_bwd_stats``) are timed beside it;
4. serving  — a synthetic 27-subject cache, 4 requests of 64 raw windows
              through ``serving/forward.py`` (Z checked finite, of shape
              (64, 1024, 360), and against the same model on the CPU), then
              the eval CLI over the test pools;
5. training — one train step on the card against the same step on the CPU
              (loss and global gradient norm within 1e-4), step times of
              the fused step (first and steady), then the train CLI
              (``cli/train_speech.py``) for one epoch of 6 updates with its
              test-pool evaluation and checkpoints: finite losses, no
              skipped step, and the exact launch count of every kernel;
    unfused_step — ``fuse_gather: false``: the pool's gather then
              ``make_train_step`` against the fused step on the same
              segments and sessions (loss and global gradient norm within
              1e-5), then the train CLI for one epoch of 6 updates with it
              (the fused CLI's exact launch counts);
6. god_data — synthetic GOD sessions (203 channels at 1000 Hz, one train
              session of 600 trials, one val session of 50; the one cut
              against the real dataset is the number of sessions), the
              train split built on the card (bandpass, resample and epoch
              gather on the device) and on the CPU: max |card − CPU| ≤
              1e-5·max|X|;
7. god_kernels — the four kernels at the GOD shapes against their plain
              versions with the checks and times of phase 3: 600 windows of
              L = 24 out of one (22, Tp) recording (and ``epoch_slice``'s
              clamps of onsets past the end), the percentiles of a
              (64, 22, 24) batch, the BN kernels at (64, 320, 24);
8. god_training — one GOD train step on the card against the CPU (loss and
              global gradient norm within 1e-4), the per-step form's times,
              then ``cli/train_god.py`` for one epoch of the cv split (7
              updates, 2 test pools): finite losses, no skipped step, the
              exact launch count of every kernel;
9. god_eval — ``cli/evaluate_god.py`` on that checkpoint: the JAX
              package's metric keys, finite, exact launch counts;
10. presets — ``configs/throughput.yaml`` and ``throughput_exact.yaml``
              as published (bf16, B = 256, the cached collate statistics,
              tanh / erf_poly GELU) on the speech cache: the sweep of every
              window's RobustScaler fit (seconds, table bytes, launches),
              its table against the CPU's on the first, a middle and the
              last chunk (within 2 ulp of the window channel's max |x|;
              raw ulps printed), the sweep chunk's gather (512 × 208 × 360)
              and quantiles (106,496 rows) and the B = 256 gathers and BN
              timed, one batch's cached vs inline collate (≤ 2 ulp), the
              first step's loss cached vs inline (≤ 1e-5), a few fused
              steps, then the train CLI for one epoch of 4 updates with
              each preset (exact launch counts);
    scan_epochs — in the speech and in the GOD part: one epoch of 4
              updates of the whole-epoch form against the per-step path on
              the same draws, in turns, cuDNN deterministic (mean loss and
              every state entry within 1e-5 relative; the times of all four
              runs printed), then the
              train CLI with ``use_scan_epochs`` (speech on the sentence
              split), exact launch counts;
    model_zoo — ``cli/train_god.py`` with ``model=eegnet`` (config_GOD's
              EEGNet hyper-parameters) and with
              ``model=brain_endcoder_seq2static window.end=0.6`` (T = 48,
              D1 = 270, D2 = 320, F = 512), each after its first step on
              the card against the CPU (loss and global gradient norm
              within 1e-4), exact launch counts; the BN kernels at EEGNet's
              shapes (64, 16, 528), (64, 32, 24), (64, 32, 12) and
              Seq2Static's (64, 320, 48) timed, and at (64, 320, 23 / 11 /
              5 / 2) checked;
    brennan_data — 33 subjects × 60 channels × 742 s at 500 Hz and a
              1024-wide stream at 120 Hz made on the card from the seed
              (no .mat files: ~3 GB), built on the card subject-wise and
              pooled (bandpass, resample, shift, robust scale of rows of
              88,920 and 2,934,360 keys, chunking, baseline), each also
              built from the first 3 subjects on the card and on the CPU:
              max |card − CPU| ≤ 1e-5·max|X|; seconds, packed bytes,
              launches (one long-row call a build);
    brennan_kernels — the quantile kernel's global-memory path against
              its plain version (≤ 1 ulp, hard rows included) at
              64 × 58,113, the subject-wise 1,980 × 88,920 and the pooled
              60 × 2,934,360 rows, timed against one read of the rows;
    brennan_training — the unfused step at the full width on the built
              dataset: its first step against the CPU (loss and global
              gradient norm within 1e-4), then the steady step and the
              device operations a step (``torch.profiler``);
    brennan_cli — the train CLI for one epoch of 4 updates on
              ``make_synthetic_brennan_raw``'s files (6 subjects × 60
              channels × 120 s, subjects pooled: rows of 84,240 keys), then
              the eval CLI on its checkpoint; exact launch counts;
    w2v_features — wav2vec2-large-xlsr-53 (317 M parameters) with seeded
              random weights: every hidden state of a 3 s clip card against
              CPU (max|Δ| ≤ 1e-4·max|ref|), a 2-layer copy's chunked,
              masked last-4 average over 45 s card against CPU (same
              bound), then the full model over 742 s of 16 kHz audio (the
              last-4 average (1024, T′) and the conv features (512, T′):
              seconds, frames/s, peak memory);
    clip_features — CLIP ViT-B/32 with seeded random weights:
              ``preprocess_images`` and ``encode_images`` over 1,250
              images of 375 × 500 (GOD's 1,200 train and 50 test), timed;
              8 of them card against CPU (pixels ≤ 1e-5, features ≤
              1e-4·max|ref|);
    gwilliams_preprocess — ``preprocess_recordings`` on one 208 × 360,000
              recording at 1000 Hz (1–60 Hz, then 120 Hz), timed; 208 ×
              60,000 card against CPU (≤ 1e-5·max|X|); then the cache
              builder's ``main`` (``cli/build_gwilliams_cache.py``) over
              synthetic audio for the four task prefixes, wav2vec2 at full
              width: ``check_preprocs``' directory choice and ``build_y``;
    brennan_embed_cli — the ``brennan_cli`` set-up with 120 s of synthetic
              audio at 44.1 kHz and no embedding stream: the train CLI
              embeds the audio at full width, writes the stream and trains
              one epoch, the eval CLI reuses the stream; exact launches;
    god_error_analysis — the GOD eval CLI with ``error_analysis`` on the
              train CLI's checkpoint, without and with a synthetic 50,000 ×
              512 distractor gallery (``top5.csv``,
              ``top5_with_imagenet_val.csv``); exact launches;
    entry_points — ``cli/main.py``'s ``train_main`` and ``evaluate_main``
              (``train_torch.py``, ``evaluate_torch.py``) on the full-width
              GOD set-up for 2 updates, then a 2-job ``-m`` sweep; the BN
              kernels' exact launches;
    serving_export — the Gwilliams seq2seq encoder (collate on) and the
              GOD encoder exported on the card (``serving/export.py``),
              loaded on the card and on the CPU: the card artifact against
              the eager serving forward at B = 1, 7, 8 and 64 (≤ 1e-5 ·
              max|ref|), against the CPU artifact (≤ 1e-4 · max|ref|), one
              request's launches (exactly one ``robust_quantiles``, nothing
              else), a weight scaled by 1.5 changing Z, and the serving
              benchmark's rows (``cli/serving_benchmark.py:latency_row``,
              eager and artifact at B = 1, 8, 64);
    export_cli — ``train_speech`` and ``train_god`` for 2 updates each,
              ``cli/export_model.py`` on each checkpoint, the artifact on
              the card against the evaluator's eager forward on the same
              checkpoint (≤ 1e-5 · max|ref|), exact launches;
    torch_import — a full-width Gwilliams encoder written under the
              reference's module names (``reference_state_dict``),
              imported by ``utils/torch_import.py`` and served on the card:
              every entry and Z bit-identical;
    spill_speech — the `training` phase's cache at B = 64: unfused steps on
              host-gathered, pinned batches through ``prefetch_to_device``
              against the device-resident unfused steps on the same draws
              (cuDNN deterministic; losses and state within 1e-5), the step
              time of each, each run again under torch.profiler for its
              split (the compute thread's time in and out of operators,
              the card's busy time, the spill producer's time a batch),
              the collate's
              percentiles through the registered op against a direct call
              of the launch (a call's host time, the step's time), the
              onsets between the two gathers' clamps,
              then the train CLI with ``host_resident`` and its epoch traced
              (``profile_dir``): the unfused CLI's launches without its
              gathers, the port's kernels and a host-to-device copy on a
              stream other than the kernels' in the trace;
    spill_god — the same for the GOD trainer: the spilled train split's
              host batches against the device-resident ones, the split and
              the route's cost, then
              ``cli/train_god.py`` with ``host_resident`` (the device CLI's
              launches) and its trace;
11. ``seconds`` (each phase group's wall time), ``step_share`` and
              ``god_step_share``, the ``kernels`` line (each
              kernel's launches by path, its times at the GOD shapes under
              ``god`` and at this slice's shapes under ``more_shapes``; the
              long-row path as ``robust_quantiles_long``), then the ``ok``
              line.

The serving, training, unfused, GOD training, GOD eval, preset, scan,
model-zoo, Brennan, error-analysis, entry-point, artifact, export, import
and spill paths each run with
every launch count set to 0 just before and read just after; the run fails
unless each kernel launched on the speech paths and on the GOD paths, every
kernel on each preset, scan, model-zoo, unfused and training entry-point
path, the long-row path on each Brennan build and CLI (with and without
the embedding), the BN kernels in Brennan training, the gather and the
percentiles on each GOD evaluation, the percentiles on each artifact,
export and import path, and the percentiles and BN kernels on both spill
CLIs.  The encoders and the preprocessing
run no TPU kernel in the JAX package, and none here.

Any failure raises and exits non-zero.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from meg_decoding_tpu_torch.cli import (
    evaluate_god,
    evaluate_speech,
    train_god,
    train_speech,
)
from meg_decoding_tpu_torch.cli.profile_train_step import profile_config
from meg_decoding_tpu_torch.cli.serving_benchmark import latency_row
from meg_decoding_tpu_torch.core.config import Config, compose, to_dict
from meg_decoding_tpu_torch.data.brennan import build_brennan_dataset
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.data.prefetch import prefetch_to_device
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.roi import roi
from meg_decoding_tpu_torch.data.synthetic import (
    CONFIGS_DIR,
    FULL_WIDTH_CACHE,
    FULL_WIDTH_GOD,
    full_width_god,
    full_width_speech,
    make_synthetic_brennan_raw,
)
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.ops.kernels import batchnorm as bk
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import quantile as qk
from meg_decoding_tpu_torch.ops.kernels import window_gather as wg
from meg_decoding_tpu_torch.ops.resample import resample_fft, resample_len
from meg_decoding_tpu_torch.data.gwilliams import (
    SWEEP_CHUNK,
    collate_stats_chunk,
    collate_stats_rows,
    compute_collate_stats,
    gather_speech_batch,
)
from meg_decoding_tpu_torch.ops.scaling import (
    collate_preprocess,
    collate_preprocess_cached,
    epoch_slice,
)
from meg_decoding_tpu_torch.serving.export import (
    load_artifact,
    make_serving_forward,
    save_artifact,
)
from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
from meg_decoding_tpu_torch.train.loop import _test_pool_starts
from meg_decoding_tpu_torch.train.scan_loop import (
    epoch_means,
    make_fused_speech_step,
    make_gwilliams_scan_epoch,
    make_scan_epoch,
)
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import make_train_step

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_FLOP_PER_S = 67e12     # H100 SXM published f32 rate outside the tensor cores
L2_BYTES = 50 * 2**20      # H100 L2 cache
C, F = FULL_WIDTH_CACHE["C"], FULL_WIDTH_CACHE["F"]
BATCH, N_REQUESTS = 64, 4
D2 = 320                   # BN width of every ConvBlock in configs/config.yaml
TRAIN_UPDATES, TIMED_STEPS = 6, 10
BN_PER_STEP = 10           # 5 ConvBlocks × (bn0, bn1)
PRESETS = ("throughput", "throughput_exact")  # configs/*.yaml, as published
PRESET_UPDATES, PRESET_STEPS = 4, 6
SCAN_UPDATES = 4
EEGNET_BN = 3              # bn1, bn2, bn3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, the L2 cache
    flushed (a 256 MB memset) before each so every run reads cold.  A time
    of one launch: it includes the launch and the events themselves."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run_ms(fns, n: int = 64, reps: int = 5) -> float:
    """Device time per call of a run of ``n`` calls ``fns[i % len(fns)]``
    between two CUDA events (median of ``reps`` runs).  The run waits behind
    a sleep kernel three times as long as the host takes to queue it, so
    the host's own time per call does not enter; each fn reads its own copy
    of the inputs (``copies``), so every call finds them cold in the L2."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int(3 * host_s * 2e9) + 10**6)  # cycles at <= 2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fns[i % len(fns)]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def copies(x: torch.Tensor, nbytes: int) -> list:
    """``x`` and clones of it, for calls that read ``nbytes`` each to take
    turns on: four times the 50 MB L2 together (at most 64 copies)."""
    k = min(64, math.ceil(4 * L2_BYTES / nbytes))
    return [x] + [x.clone() for _ in range(k - 1)]


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in f32 ulps; positions where both are NaN count 0."""
    def ordered(x):
        k = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(k < 0, -(k & 0x7FFFFFFF), k)
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return int(d.max())


def phase_build() -> None:
    info = build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in info["log"].items()}
    emit({"phase": "build", "seconds": info["seconds"], "ptxas": ptxas})


def phase_device() -> None:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})


def gather_case(src, B, L, seed, out_dtype, flush):
    """One window_gather shape of the main path: onsets at every 16-byte
    residue, one far out of range, one negative."""
    R, Cs, T = src.shape
    g = torch.Generator().manual_seed(seed)
    rec = torch.randint(0, R, (B,), generator=g, dtype=torch.int32)
    on = torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
    on[:4] = torch.tensor([0, 1, 2, 3], dtype=torch.int32) + 400
    on[4], on[5] = 10**6, -7
    rec, on = rec.cuda(), on.cuda()
    got = wg.window_gather(src, rec, on, L, out_dtype=out_dtype)
    want = wg.window_gather_plain(src, rec, on, L, out_dtype=out_dtype)
    torch.cuda.synchronize()
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), want.view(bits)):
        raise AssertionError(f"window_gather {tuple(src.shape)} {out_dtype}: "
                             "kernel and plain version differ")
    err = float((got.float() - want.float()).abs().max())
    # the library yardstick: one advanced-indexing call on ready indices
    on_c = on.long().clamp(0, T - wg.padded_window(L))
    i_r = rec.long()[:, None, None]
    i_c = torch.arange(Cs, device=src.device)[None, :, None]
    i_t = (on_c[:, None] + torch.arange(L, device=src.device))[:, None, :]
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    # the bytes the data needs: every source sample some window covers,
    # read once (overlapping windows, as the 4 task streams' Y windows
    # are, share their reads), each output written once, the indices
    covered = torch.zeros(R * T, dtype=torch.bool, device=src.device)
    covered[(rec.long()[:, None] * T + i_t[:, 0, :]).reshape(-1)] = True
    nbytes = (int(covered.sum()) * Cs * 4 + B * Cs * L * out_bytes
              + 2 * B * 4)
    return {
        "shape": [B, Cs, L], "src": list(src.shape),
        "out_dtype": str(out_dtype or torch.float32),
        "tolerance": "bit-exact", "bit_exact": True, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: wg.window_gather(
            src, rec, on, L, out_dtype=out_dtype), flush),
        "run_ms": run_ms([lambda s=s: wg.window_gather(
            s, rec, on, L, out_dtype=out_dtype)
            for s in copies(src, B * Cs * L * 4)]),
        "plain_ms": time_ms(lambda: wg.window_gather_plain(
            src, rec, on, L, out_dtype=out_dtype), flush),
        "library_ms": (time_ms(lambda: src[i_r, i_c, i_t], flush)
                       if out_dtype is None else None),
        "bytes": nbytes,
        "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
    }


def phase_kernels(ds, flush) -> dict:
    # the time a run gives a launch that does nothing: one 4-byte memset
    emit({"phase": "kernels",
          "launch_floor_ms": run_ms([lambda: flush[:1].zero_()])})
    S, NT, Cx, T = ds.recordings.shape
    L = ds.seq_len
    rec_flat = ds.recordings.reshape(S * NT, Cx, T)
    cases = [gather_case(rec_flat, BATCH, L, 1, None, flush),
             gather_case(ds.y_stream, BATCH, L, 2, None, flush),
             gather_case(ds.y_stream, BATCH, L, 3, torch.bfloat16, flush)]
    for c in cases:
        emit({"phase": "kernels", "kernel": "window_gather", **c})
    # off the main path's shapes: the scalar variant (L not a multiple of 4)
    # and a last channel tile of fewer than 16 rows
    ids = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device="cuda")
    ons = torch.tensor([5, 130, 10**6, -3], dtype=torch.int32, device="cuda")
    for Cs, Ls in ((16, 37), (21, L)):
        small = rec_flat[:3, :Cs].contiguous()
        if not torch.equal(wg.window_gather(small, ids, ons, Ls),
                           wg.window_gather_plain(small, ids, ons, Ls)):
            raise AssertionError(f"window_gather (C = {Cs}, L = {Ls}): "
                                 "kernel and plain version differ")

    # percentiles of a baseline-corrected X batch, as the collate fits them
    X = wg.window_gather(rec_flat, torch.arange(BATCH, device="cuda") % (S * NT),
                         torch.arange(BATCH, device="cuda") * 17, L)
    x2d = (X - X[..., :60].mean(-1, keepdim=True)).reshape(-1, L).contiguous()
    quant = quantile_checks(x2d, flush)
    quantile_edges()
    emit({"phase": "kernels", "kernel": "robust_quantiles", **quant})
    return {"gather": cases, "quantiles": quant}


def with_hard_rows(x2d: torch.Tensor) -> torch.Tensor:
    """Rows of NaN (both signs), ±inf, ±0, constants and duplicates, and one
    row whose six order statistics (rank and rank + 1 of the 25/50/75th
    percentiles) all fall in one run of equal values."""
    T = x2d.shape[1]
    x2d[0] = 3.0
    x2d[1, ::3] = float("nan")
    x2d[2, ::4] = -float("nan")
    x2d[3, ::2], x2d[3, 1::2] = float("inf"), -float("inf")
    x2d[4, ::2], x2d[4, 1::2] = 0.0, -0.0
    x2d[5, : T // 2], x2d[5, T // 2:] = 1.0, -1.0
    x2d[6] = torch.round(x2d[6])
    lo, hi = T // 5, T - T // 5  # the run covers sorted positions lo … hi-1
    x2d[7, :lo] = -1.0 - x2d[7, :lo].abs()
    x2d[7, lo:hi] = 0.5
    x2d[7, hi:] = 2.0 + x2d[7, hi:].abs()
    return x2d


def quantile_check(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The kernel against its plain version: equal NaN positions, ≤ 1 ulp."""
    got = qk.robust_quantiles(x2d)
    want = qk.robust_quantiles_plain(x2d)
    torch.cuda.synchronize()
    shape = tuple(x2d.shape)
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"robust_quantiles {shape}: NaN positions differ")
    ulps = ulp_distance(got, want)
    if ulps > 1:
        raise AssertionError(f"robust_quantiles {shape}: {ulps} ulp from the "
                             "plain version")
    return got, want, ulps


def quantile_edges() -> None:
    """robust_quantiles off the main paths' shapes: a last CTA with fewer
    rows than warps; rows shorter than a warp; 31, 32, 33 keys (one key per
    lane and the step to two); the register path's limit of 1024 keys (32
    per lane) and 1025 (the shared-memory bisection); rows whose keys need
    more than the default 48 KB of shared memory."""
    g = torch.Generator(device="cuda").manual_seed(4)
    for n, t in ((45, 7), (13, 1), (9, 2), (45, 31), (45, 32), (45, 33),
                 (45, qk.REGISTER_MAX_T), (45, qk.REGISTER_MAX_T + 1),
                 (37, 20000)):
        xe = torch.randn(n, t, device="cuda", generator=g)
        quantile_check(with_hard_rows(xe) if t >= 8 else xe)


def quantile_checks(x2d: torch.Tensor, flush) -> dict:
    """robust_quantiles on a main path's (N, T) batch with its hard rows,
    timed."""
    N, L = x2d.shape
    got, want, ulps = quantile_check(with_hard_rows(x2d))
    fin = torch.isfinite(got) & torch.isfinite(want)
    q_lib = torch.tensor([0.25, 0.5, 0.75], device="cuda")
    q_bytes = N * L * 4 + N * 3 * 4
    return {"shape": [N, L], "tolerance": "<= 1 ulp", "max_ulp": ulps,
            "max_abs_err": float((got[fin] - want[fin]).abs().max()),
            "kernel_ms": time_ms(lambda: qk.robust_quantiles(x2d), flush),
            "run_ms": run_ms([lambda x=x: qk.robust_quantiles(x)
                              for x in copies(x2d, q_bytes)]),
            "plain_ms": time_ms(lambda: qk.robust_quantiles_plain(x2d), flush),
            "library_ms": time_ms(lambda: torch.quantile(x2d, q_lib, dim=1),
                                  flush),
            "bytes": q_bytes, "bound_us": q_bytes / HBM_BYTES_PER_S * 1e6}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms, what sets it) on the published H100 rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value of ``t`` (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def bn_bwd_check(g, x, scale, mean, invstd, got, want, what: str) -> dict:
    """bn_bwd's (dx, Σg, Σg·x̂) ``got`` against the plain version's
    ``want``: each sum within 1e-5 of Σ|term| per channel (f32 sums taken in
    another order); dx per element within 1e-5·|scale·invstd|·(|g| + Σ|g|/M
    + |x̂|·Σ|g·x̂|/M), the sums' tolerance carried through dx, plus one bf16
    ulp of the plain dx in bf16.  Returns the largest absolute errors."""
    dx, sg, sgx = got
    pdx, psg, psgx = want
    M = x.numel() // x.shape[1]
    gf = g.float()
    xhat = (x.float() - mean[:, None]) * invstd[:, None]
    abs_g = gf.abs().sum((0, 2))
    abs_gx = (gf * xhat).abs().sum((0, 2))
    err = {}
    for key, a, b, scale_ in (("sum_g", sg, psg, abs_g),
                              ("sum_gxhat", sgx, psgx, abs_gx)):
        d = (a - b).abs()
        if not bool((d <= 1e-5 * scale_).all()):
            raise AssertionError(f"{what}: {key} off by "
                                 f"{float((d / scale_).max())} of Σ|term|")
        err[key] = float(d.max())
    tol = 1e-5 * (scale * invstd).abs()[:, None] * (
        gf.abs() + (abs_g / M)[:, None] + xhat.abs() * (abs_gx / M)[:, None])
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(pdx)
    d = (dx.float() - pdx.float()).abs()
    if not bool((d <= tol).all()):
        raise AssertionError(f"{what}: dx off by {float((d / tol).max())} "
                             "of its bound")
    err["dx"] = float(d.max())
    return err


def bn_check(x: torch.Tensor, g: torch.Tensor, cotangents: bool = False) -> dict:
    """The BN kernels on (x, g) against their plain versions, each launched
    twice and the two launches bit-identical (no atomics): the statistics
    per channel |kernel − plain| ≤ 1e-5·Σ|term| (f32 sums taken in another
    order); bn_bwd's dx within ``bn_bwd_check``'s bound, with the mean and
    var cotangents when ``cotangents``."""
    shape = tuple(x.shape)
    C = x.shape[1]
    M = x.numel() // C
    s, ss = bk.bn_stats(x)
    mean = s / M
    invstd = torch.rsqrt(ss / M - mean * mean + 1e-5)
    gen = torch.Generator(device="cuda").manual_seed(C)
    scale = torch.rand(C, device="cuda", generator=gen) + 0.5
    cots = ((torch.randn(C, device="cuda", generator=gen),
             torch.randn(C, device="cuda", generator=gen))
            if cotangents else (None, None))
    got = {"sum_x": s, "sum_x2": ss}
    got["sum_g"], got["sum_gxhat"] = bk.bn_bwd_stats(g, x, mean, invstd)
    again = dict(zip(("sum_x", "sum_x2"), bk.bn_stats(x)))
    again.update(zip(("sum_g", "sum_gxhat"), bk.bn_bwd_stats(g, x, mean, invstd)))
    bwd = [bk.bn_bwd(g, x, scale, mean, invstd, *cots) for _ in range(2)]
    want = dict(zip(("sum_x", "sum_x2"), bk.bn_stats_plain(x)))
    want.update(zip(("sum_g", "sum_gxhat"),
                    bk.bn_bwd_stats_plain(g, x, mean, invstd)))
    xf, gf = x.float(), g.float()
    xhat = (xf - mean[:, None]) * invstd[:, None]
    scale_ = {"sum_x": xf.abs().sum((0, 2)), "sum_x2": (xf * xf).sum((0, 2)),
              "sum_g": gf.abs().sum((0, 2)),
              "sum_gxhat": (gf * xhat).abs().sum((0, 2))}
    torch.cuda.synchronize()
    err = {}
    for k in got:
        if not torch.equal(got[k], again[k]):
            raise AssertionError(f"BN statistics {shape} {x.dtype}: {k} differs "
                                 "between two launches")
        d = (got[k] - want[k]).abs()
        if not bool((d <= 1e-5 * scale_[k]).all()):
            raise AssertionError(f"BN statistics {shape} {x.dtype}: {k} off by "
                                 f"{float((d / scale_[k]).max())} of Σ|term|")
        err[k] = float(d.max())
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    (dx, sg, sgx), (dx2, sg2, sgx2) = bwd
    if not (torch.equal(dx.view(bits), dx2.view(bits)) and torch.equal(sg, sg2)
            and torch.equal(sgx, sgx2)):
        raise AssertionError(f"bn_bwd {shape} {x.dtype}: two launches differ")
    for k, v in bn_bwd_check(g, x, scale, mean, invstd, bwd[0],
                             bk.bn_bwd_plain(g, x, scale, mean, invstd, *cots),
                             f"bn_bwd {shape} {x.dtype}").items():
        err[f"bn_bwd_{k}"] = v
    return err


def library_time(fn, flush) -> tuple[float | None, str | None]:
    """``time_ms`` of a PyTorch yardstick, or (None, why) where PyTorch
    refuses these inputs."""
    try:
        return time_ms(fn, flush), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def bn_inputs(gen, B, Cc, T, dtype, offset=0):
    """(x, g) of shape (B, Cc, T) on the card, ``offset`` elements past an
    allocation's start."""
    n = B * Cc * T + offset
    x = (torch.randn(n, device="cuda", generator=gen) * 3 + 1.5).to(dtype)
    g = torch.randn(n, device="cuda", generator=gen).to(dtype)
    return x[offset:].view(B, Cc, T), g[offset:].view(B, Cc, T)


def bn_rows(x, g, flush, phase: str) -> dict:
    """The BN kernels on a main path's (x, g) — checked (``bn_check``, with
    and without the mean/var cotangents), timed and emitted: bn_stats,
    bn_bwd (the layer's backward, the kernel of the train path) as the
    ``bn_bwd_stats`` row, and its sums alone beside it (the one-to-one
    counterpart of the Pallas kernel)."""
    dtype = x.dtype
    err = bn_check(x, g)
    err.update({f"cot_{k}": v for k, v in bn_check(x, g, True).items()})
    Cc = x.shape[1]
    M = x.numel() // Cc
    mean = torch.zeros(Cc, device="cuda")
    invstd = torch.ones(Cc, device="cuda")
    scale = torch.ones(Cc, device="cuda")
    n, esize = x.numel(), x.element_size()
    xs, gs = copies(x, n * esize), copies(g, n * esize)
    fwd_bound = bound(n * esize + 2 * Cc * 4, 3 * n)
    sums_bound = bound(2 * n * esize + 4 * Cc * 4, 5 * n)
    bwd_bound = bound(3 * n * esize + 5 * Cc * 4, 12 * n)
    lib_stats = library_time(lambda: torch.batch_norm_stats(x, 1e-5), flush)
    lib_reduce = library_time(lambda: torch.batch_norm_backward_reduce(
        g, x, mean, invstd, scale, False, True, True), flush)
    lib_bwd = library_time(lambda: torch.ops.aten.native_batch_norm_backward(
        g, x, scale, None, None, mean, invstd, True, 1e-5,
        [True, True, True]), flush)
    rows = {
        "bn_stats": {
            "max_abs_err": max(err["sum_x"], err["sum_x2"]),
            "kernel_ms": time_ms(lambda: bk.bn_stats(x), flush),
            "run_ms": run_ms([lambda x=x: bk.bn_stats(x) for x in xs]),
            "plain_ms": time_ms(lambda: bk.bn_stats_plain(x), flush),
            "library_ms": time_ms(lambda: torch.var_mean(
                x, dim=(0, 2), correction=0), flush),
            "library_batch_norm_stats_ms": lib_stats[0],
            "library_batch_norm_stats_refused": lib_stats[1],
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
        "bn_bwd_stats": {
            "max_abs_err": max(v for k, v in err.items()
                               if k.startswith(("bn_bwd_", "cot_bn_bwd_"))),
            "kernel_ms": time_ms(lambda: bk.bn_bwd(g, x, scale, mean,
                                                   invstd), flush),
            "run_ms": run_ms([lambda g=g, x=x: bk.bn_bwd(
                g, x, scale, mean, invstd) for g, x in zip(gs, xs)]),
            "plain_ms": time_ms(lambda: bk.bn_bwd_plain(
                g, x, scale, mean, invstd), flush),
            "library_ms": lib_bwd[0],
            "library": "torch.ops.aten.native_batch_norm_backward",
            "library_refused": lib_bwd[1],
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
            "stats_only_max_abs_err": max(err["sum_g"], err["sum_gxhat"]),
            "stats_only_ms": time_ms(lambda: bk.bn_bwd_stats(
                g, x, mean, invstd), flush),
            "stats_only_run_ms": run_ms([lambda g=g, x=x: bk.bn_bwd_stats(
                g, x, mean, invstd) for g, x in zip(gs, xs)]),
            "stats_only_plain_ms": time_ms(lambda: bk.bn_bwd_stats_plain(
                g, x, mean, invstd), flush),
            "stats_only_library_ms": lib_reduce[0],
            "stats_only_library": "torch.batch_norm_backward_reduce",
            "stats_only_library_refused": lib_reduce[1],
            "stats_only_bound_ms": sums_bound[0]},
    }
    for name, row in rows.items():
        emit({"phase": phase, "kernel": name, "shape": list(x.shape),
              "dtype": str(dtype), "M": M,
              "tolerance": "sums: 1e-5 of sum |term| per channel; dx: "
                           "bn_bwd_check's bound; bit-identical across "
                           "two launches", **row})
    return rows


def phase_bn_kernels(flush) -> dict:
    """The BN kernels at the speech training step's shape (64, 320, 360) in
    f32 and bf16, timed (``bn_rows``), and at shapes off the main paths."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {str(dtype): bn_rows(*bn_inputs(gen, BATCH, D2, 360, dtype), flush,
                               "kernels")
           for dtype in (torch.float32, torch.bfloat16)}
    # off the main paths' shapes: C of 21, T = 37 (rows not 16-byte
    # aligned: the element-wise loop), B·T below one CTA's thread count, a
    # base address 4 bytes past a 16-byte boundary, one channel, B = 65 (not
    # a multiple of 4), rows longer than a CTA's threads, and B = 256 in f32
    # (too many rows for the register kernel: the two-walk kernel); the
    # mean and var cotangents on the element-wise loop and at B = 256
    for B, Cc, T, dtype, offset, cot in (
            (BATCH, 21, 360, torch.float32, 0, False),
            (3, D2, 37, torch.float32, 0, False),
            (3, D2, 37, torch.bfloat16, 0, True),
            (1, 7, 40, torch.float32, 0, False),
            (2, 5, 64, torch.float32, 1, False),
            (BATCH, 1, 360, torch.float32, 0, False),
            (1, 3, 8, torch.bfloat16, 0, False),
            (3, 1, 5, torch.bfloat16, 0, False),
            (BATCH + 1, 24, 360, torch.float32, 0, False),
            (BATCH + 1, 24, 360, torch.bfloat16, 0, False),
            (6, 3, 4096, torch.float32, 0, False),
            (6, 3, 1001, torch.float32, 0, False),
            (4 * BATCH, 24, 360, torch.float32, 0, True)):
        bn_check(*bn_inputs(gen, B, Cc, T, dtype, offset), cotangents=cot)
    return out


def phase_serving(cfg, ds, tr_idx, seed) -> dict:
    """The main path: requests through the serving forward, then the eval
    CLI over the test pools.  Returns the launch counts of the run."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    model = get_model(cfg, loc, device=dev, seed=seed)
    ckpt_dir = os.path.join(cfg.save_root, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(dict(model.state_dict(),
                    **{"loss.temp": torch.tensor(float(cfg.init_temperature))}),
               os.path.join(ckpt_dir, "model.pt"))
    forward = make_serving_forward(evaluate_speech.collate_config(cfg))
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)

    reset_all_launches()
    req_ms, gather_ms, first = [], [], None
    for r in range(N_REQUESTS):
        idx = np.arange(r * BATCH, (r + 1) * BATCH) % len(pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, Y, subs = pool.gather(idx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        Z = forward(model, X, subs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gather_ms.append((t1 - t0) * 1e3)
        req_ms.append((t2 - t1) * 1e3)
        if tuple(Z.shape) != (BATCH, F, ds.seq_len) or not bool(torch.isfinite(Z).all()):
            raise AssertionError(f"request {r}: Z {tuple(Z.shape)} not finite "
                                 "or of the wrong shape")
        if first is None:
            first = (X[:8].cpu(), subs[:8].cpu(), Z[:8].cpu())
    results = evaluate_speech.run(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = {"window_gather": wg.launches, "robust_quantiles": qk.launches}

    # the same model and windows on the CPU (plain collate, f32 convs)
    cpu_model = get_model(cfg, loc, device="cpu", seed=seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    X8, s8, Z8 = first
    Z_cpu = forward(cpu_model, X8, s8)
    rel = float((Z8 - Z_cpu).abs().max() / Z_cpu.abs().max())
    if not rel <= 1e-4:
        raise AssertionError(f"card vs CPU forward: max|ΔZ|/max|Z| = {rel}")
    emit({"phase": "serving", "Z_shape": [BATCH, F, ds.seq_len],
          "Z_finite": True, "requests": N_REQUESTS,
          "request_ms": req_ms, "gather_ms": gather_ms,
          "card_vs_cpu_rel_err": rel, "rel_err_limit": 1e-4,
          "eval": results, "launches": launches})
    return launches


def reset_all_launches() -> None:
    wg.reset_launches()
    qk.reset_launches()
    bk.reset_launches()


def all_launches() -> dict:
    return {"window_gather": wg.launches, "robust_quantiles": qk.launches,
            **bk.launches}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / abs(b)


def phase_training(cfg, ds, tr_idx, seed, work) -> dict:
    """One step on the card against the CPU, the fused step's times, then
    the main path: the train CLI for one epoch.  Returns its launch counts."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    loss_cfg = dataclasses.replace(train_speech.loss_config(cfg), grad_norms=True)
    collate_cfg = evaluate_speech.collate_config(cfg)
    updates = int(cfg.updates)

    def train_state(device):
        model = get_model(cfg, loc, device=device, seed=seed)
        opt = make_optimizer(cfg, updates)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        return model, opt, state

    # one step on the card and on the CPU: same weights, batch and centre
    model, opt, state = train_state(dev)
    cpu_model, cpu_opt, cpu_state = train_state("cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    X, Y, subs = pool.gather(np.arange(BATCH))
    centre = int(torch.randint(C, (), generator=torch.Generator().manual_seed(seed)))
    step = make_train_step(model, opt, loss_cfg, collate_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, X, Y, subs, centre=centre)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    cpu_step = make_train_step(cpu_model, cpu_opt, loss_cfg, collate_cfg)
    _, mc = cpu_step(cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=centre)
    check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
             "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
        raise AssertionError(f"card vs CPU train step: {check}")

    # the fused step (session draw + gather + step) as the trainer runs it
    fused = make_fused_speech_step(model, opt, loss_cfg, collate_cfg, ds)
    rng = np.random.RandomState(seed)
    step_ms, losses = [], []
    for i in range(TIMED_STEPS):
        idx = pool.segment_ids(rng.randint(0, len(pool), BATCH))
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fused(state, idx, generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if float(m["skipped"]) != 0.0 or not math.isfinite(losses[-1]):
            raise AssertionError(f"fused step {i}: loss {losses[-1]}, "
                                 f"skipped {float(m['skipped'])}")
    del model, opt, state, cpu_model, cpu_opt, cpu_state

    # the main path: the train CLI, one epoch of TRAIN_UPDATES updates with
    # its test-pool evaluation and checkpoints
    out = os.path.join(work, "train_out")
    tcfg = compose(CONFIGS_DIR, "config", [
        f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
        f"batch_size={BATCH}", "epochs=1", f"updates={TRAIN_UPDATES}",
        "run_name=smoke"])
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_speech.run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    # the BN backward is bn_bwd's one kernel a layer: no launch of the sums
    # alone (which would need an eager dx chain after it)
    if bk.sums_only_launches != 0:
        raise AssertionError(f"train CLI: {bk.sums_only_launches} launches of "
                             "bn_bwd_stats's sums alone, expected 0")

    with open(os.path.join(out, "runs", "smoke", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != 1 or rows[0]["train_skipped"] != 0.0 \
            or not math.isfinite(rows[0]["train_loss"]):
        raise AssertionError(f"train CLI: {rows}")
    model, _, fresh = train_state(dev)
    restored = CheckpointManager(os.path.join(out, "ckpt")).restore("model_last",
                                                                   fresh)
    if int(restored.step) != TRAIN_UPDATES:
        raise AssertionError(f"model_last holds step {int(restored.step)}")
    # every launch accounted for: per update 2 gathers, 1 collate, 10 BN
    # forward statistics and 10 BN backward kernels; per test pool 2
    # gathers and 1 collate (eval-mode BN uses the running statistics)
    n_test = len(ds) - len(tr_idx)
    pools = len(_test_pool_starts(
        n_test, min(n_test, int(tcfg.get("test_size", BATCH))),
        bool(tcfg.get("test_sweep", True))))
    expected = {"window_gather": 2 * (TRAIN_UPDATES + pools),
                "robust_quantiles": TRAIN_UPDATES + pools,
                "bn_stats": BN_PER_STEP * TRAIN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * TRAIN_UPDATES}
    if launches != expected:
        raise AssertionError(f"train CLI launches {launches}, expected {expected}")
    emit({"phase": "training", "card_vs_cpu": check, "rel_err_limit": 1e-4,
          "first_step_ms": first_ms, "fused_step_ms": step_ms,
          "steady_step_ms": float(np.median(step_ms[1:])),
          "fused_losses": losses, "train_cli_s": run_s,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "train_top1", "train_top10",
                                             "test_loss", "test_top1",
                                             "test_top10")},
          "test_pools": pools, "launches": launches,
          "bn_bwd_sums_only_launches": bk.sums_only_launches})
    return {"launches": launches, "steady_step_ms": float(np.median(step_ms[1:]))}


GOD_EVAL_KEYS = {"val_top1", "val_top10", "zeroshot_top1", "zeroshot_top10",
                 "pairwise_correlation", "pairwise_cosine"}
GOD_DATA_RTOL = 1e-5  # card vs CPU epochs: f32 FFTs of ~6e5 samples, two libraries


def phase_god_data(work, seed):
    """The GOD train split (filter, resample and epoch gather on the
    device) built on the card and on the CPU, the same host arithmetic
    before and after: max |card − CPU| ≤ GOD_DATA_RTOL·max|X|, the rest
    exactly equal.  Returns the config and the card's dataset."""
    t0 = time.perf_counter()
    cfg = full_width_god(work, seed, [
        f"save_root={os.path.join(work, 'god_out')}", f"batch_size={BATCH}",
        "epochs=1", "run_name=smoke"])
    write_s = time.perf_counter() - t0
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = build_god_dataset(cfg, "train", device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    if wg.launches != 1:
        raise AssertionError(f"GOD train build: {wg.launches} gathers, expected 1")
    t0 = time.perf_counter()
    cpu = build_god_dataset(cfg, "train", device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float((ds.X.cpu() - cpu.X).abs().max())
    peak = float(cpu.X.abs().max())
    if not err <= GOD_DATA_RTOL * peak:
        raise AssertionError(f"GOD data card vs CPU: max|ΔX| {err}, max|X| {peak}")
    for k in ("Y", "subject_idxs", "labels"):
        if not torch.equal(getattr(ds, k).cpu(), getattr(cpu, k)):
            raise AssertionError(f"GOD data card vs CPU: {k} differs")
    emit({"phase": "god_data", "X": list(ds.X.shape), "Y": list(ds.Y.shape),
          "windows": len(ds), "roi_channels": int(ds.X.shape[1]),
          "write_s": write_s, "card_build_s": card_s, "cpu_build_s": cpu_s,
          "max_abs_err": err, "max_abs_X": peak,
          "limit": f"{GOD_DATA_RTOL} * max|X|",
          "reduced": "1 subject, 1 train session of 600 trials and 1 val "
                     "session of 50 (the real dataset has several sessions "
                     "per subject); synthetic MEG"})
    return cfg, ds


def phase_god_kernels(cfg, ds, flush) -> dict:
    """The four kernels at the GOD path's shapes against their plain
    versions, with the checks and times of the speech shapes: the epoch
    gather of 600 windows of L = 24 out of one (22, Tp) recording (plus
    ``epoch_slice``'s two clamps on onsets past T − L and past Tp), the
    percentiles of a collated (64, 22, 24) batch, and the BN kernels at
    (64, 320, 24) in f32 and bf16."""
    fs = float(FULL_WIDTH_GOD["fs"])
    rate = float(cfg.preprocs.brain_resample_rate)
    T = resample_len(int(fs * (FULL_WIDTH_GOD["n_train"] + 4)), down=fs / rate)
    L = int(ds.X.shape[2])
    Cr = int(ds.X.shape[1])
    gen = torch.Generator(device="cuda").manual_seed(6)
    src = torch.randn(1, Cr, wg.pad_time_for_gather(T, L), device="cuda",
                      generator=gen)
    gather = gather_case(src, len(ds), L, 7, None, flush)
    x = src[0, :, :T].contiguous()
    onsets = torch.tensor([0, 5, T - L, T - L + 7, T + 100, 10**6, -3])
    got = epoch_slice(x, onsets.cuda(), L).cpu()
    if not (torch.equal(got, epoch_slice(x.cpu(), onsets, L))
            and torch.equal(got[3], x[:, T - L:].cpu())):
        raise AssertionError("epoch_slice: card and CPU windows differ")
    emit({"phase": "god_kernels", "kernel": "window_gather",
          "recording_T": T, **gather})
    # the collate's percentiles of one GOD batch (baseline_len_sec 0)
    quant = quantile_checks(ds.X[:BATCH].reshape(-1, L).clone(), flush)
    emit({"phase": "god_kernels", "kernel": "robust_quantiles", **quant})
    bn = {str(dtype): bn_rows(*bn_inputs(gen, BATCH, D2, L, dtype), flush,
                              "god_kernels")
          for dtype in (torch.float32, torch.bfloat16)}
    return {"gather": gather, "quantiles": quant, "bn": bn}


def phase_god_training(cfg, ds, seed) -> dict:
    """One GOD train step on the card against the same step on the CPU, the
    per-step form's times, then the main path: ``cli/train_god.py`` for one
    epoch.  Returns its launch counts."""
    dev = torch.device("cuda")
    cfg.num_subjects = ds.num_subjects
    loc = ch_locations_2d(cfg, roi(cfg))
    loss_cfg = dataclasses.replace(train_god._loss_config(cfg), grad_norms=True)
    collate_cfg = evaluate_speech.collate_config(cfg)

    def train_state(device):
        model = get_model(cfg, loc, device=device, seed=seed)
        opt = make_optimizer(cfg, int(cfg.updates))
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    model, opt, state = train_state(dev)
    cpu_model, cpu_opt, cpu_state = train_state("cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    X, Y, subs, _ = ds.gather(np.arange(BATCH))
    centre = int(torch.randint(len(loc), (), generator=torch.Generator().manual_seed(seed)))
    step = make_train_step(model, opt, loss_cfg, collate_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, X, Y, subs, centre=centre)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    cpu_step = make_train_step(cpu_model, cpu_opt, loss_cfg, collate_cfg)
    _, mc = cpu_step(cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=centre)
    check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
             "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
        raise AssertionError(f"card vs CPU GOD train step: {check}")

    # the per-step form as fit runs it: gather from the packed set + step
    rng = np.random.RandomState(seed)
    step_ms, losses = [], []
    for i in range(TIMED_STEPS):
        idx = rng.randint(0, len(ds), BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, *ds.gather(idx)[:3])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if float(m["skipped"]) != 0.0 or not math.isfinite(losses[-1]):
            raise AssertionError(f"GOD step {i}: loss {losses[-1]}, "
                                 f"skipped {float(m['skipped'])}")
    del model, opt, state, cpu_model, cpu_opt, cpu_state

    # the main path: the train CLI, one epoch over the cv split
    tcfg = Config(to_dict(cfg))
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_god.run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    if bk.sums_only_launches != 0:
        raise AssertionError(f"GOD train CLI: {bk.sums_only_launches} launches "
                             "of bn_bwd_stats's sums alone, expected 0")
    with open(os.path.join(cfg.save_root, "runs", "smoke", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != 1 or rows[0]["train_skipped"] != 0.0 \
            or not (math.isfinite(rows[0]["train_loss"])
                    and math.isfinite(rows[0]["test_loss"])):
        raise AssertionError(f"GOD train CLI: {rows}")
    # the cv split: 5/6 of the 600 windows train (7 full batches of 64),
    # the rest are the test pools; one gather builds the train split; per
    # update 1 collate, 10 BN forward statistics and 10 BN backward
    # kernels; per test pool 1 collate
    n_train = int(round(len(ds) * 5 / 6))
    updates = n_train // BATCH
    pools = len(_test_pool_starts(len(ds) - n_train,
                                  min(len(ds) - n_train, int(cfg.test_size)),
                                  bool(cfg.get("test_sweep", True))))
    model, _, fresh = train_state(dev)
    restored = CheckpointManager(os.path.join(cfg.save_root, "ckpt")).restore(
        "model_last", fresh)
    if int(restored.step) != updates:
        raise AssertionError(f"GOD model_last holds step {int(restored.step)}, "
                             f"expected {updates}")
    expected = {"window_gather": 1, "robust_quantiles": updates + pools,
                "bn_stats": BN_PER_STEP * updates,
                "bn_bwd_stats": BN_PER_STEP * updates}
    if launches != expected:
        raise AssertionError(f"GOD train CLI launches {launches}, expected {expected}")
    emit({"phase": "god_training", "card_vs_cpu": check, "rel_err_limit": 1e-4,
          "first_step_ms": first_ms, "step_ms": step_ms,
          "steady_step_ms": float(np.median(step_ms[1:])), "losses": losses,
          "train_cli_s": run_s, "updates": updates, "test_pools": pools,
          "train_cli": {k: best[k] for k in (
              "train_loss", "train_skipped", "train_top1", "train_top10",
              "test_loss", "test_top1", "test_top10", "t_gather_ms",
              "t_step_ms")},
          "launches": launches,
          "bn_bwd_sums_only_launches": bk.sums_only_launches})
    return {"launches": launches, "steady_step_ms": float(np.median(step_ms[1:]))}


def phase_god_eval(cfg) -> dict:
    """The main path: ``cli/evaluate_god.py`` on the checkpoint the train
    CLI wrote.  Returns its launch counts."""
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = evaluate_god.run(Config(to_dict(cfg)), device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = all_launches()
    if set(results) != GOD_EVAL_KEYS or not all(map(math.isfinite, results.values())):
        raise AssertionError(f"GOD eval CLI: {results}")
    # the train and the val split, one gather each; the 50 val epochs (one
    # per image) in one predict batch, one collate; eval-mode BN launches
    # no BN kernel
    expected = {"window_gather": 2, "robust_quantiles": 1, "bn_stats": 0,
                "bn_bwd_stats": 0}
    if launches != expected:
        raise AssertionError(f"GOD eval CLI launches {launches}, expected {expected}")
    emit({"phase": "god_eval", "eval": results, "eval_cli_s": eval_s,
          "launches": launches})
    return launches


def max_abs_ulp(t: torch.Tensor) -> torch.Tensor:
    """One f32 ulp of |t|."""
    a = t.abs().float()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def params_rel_err(a: torch.nn.Module, b: torch.nn.Module) -> float:
    """Largest max|Δp| / max|p| over the two models' state entries."""
    sb = b.state_dict()
    worst = 0.0
    for k, v in a.state_dict().items():
        ref = sb[k].float()
        d = float((v.float() - ref).abs().max())
        worst = max(worst, d / max(float(ref.abs().max()), 1e-30))
    return worst


def phase_presets(cfg, ds, tr_idx, seed, work, flush) -> dict:
    """The published speed presets (``configs/throughput.yaml``,
    ``configs/throughput_exact.yaml``: bf16, B = 256, the cached collate
    statistics, tanh / erf_poly GELU) on the speech cache: the sweep timed
    and held against the CPU on a sample of chunks, the sweep chunk's
    kernels timed, one batch's cached vs inline collate, the first step's
    loss cached vs inline, a few fused steps, then the main path: the train
    CLI for one epoch of each preset.  Returns the CLIs' launch counts."""
    dev = torch.device("cuda")
    collate = evaluate_speech.collate_config(cfg)
    bl = collate.baseline_len_samp
    S, NT, Cx, T = ds.recordings.shape
    W = int(ds.meg_onsets.shape[2])
    L = int(ds.seq_len)
    total = S * NT * W
    n_chunks = math.ceil(total / SWEEP_CHUNK)

    # the sweep, timed, with its launches
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = compute_collate_stats(ds, bl, chunk=SWEEP_CHUNK)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = all_launches()
    want = {"window_gather": n_chunks, "robust_quantiles": n_chunks,
            "bn_stats": 0, "bn_bwd_stats": 0}
    if sweep_launches != want:
        raise AssertionError(f"sweep launches {sweep_launches}, expected {want}")
    # against the CPU's sweep of the first, a middle and the last chunk:
    # raw ulps, and the error in ulps of the window channel's max |x| (the
    # baseline mean is summed in another order on the two devices)
    rec_cpu = ds.recordings.cpu()
    rec_ids = torch.arange(S * NT, dtype=torch.int32).repeat_interleave(W)
    onsets = ds.meg_onsets.reshape(total).cpu()
    raw_ulps, window_ulps, chunks = 0, 0.0, sorted({0, n_chunks // 2, n_chunks - 1})
    for c in chunks:
        a, b = c * SWEEP_CHUNK, min(total, (c + 1) * SWEEP_CHUNK)
        want_rows = collate_stats_chunk(rec_cpu, rec_ids[a:b], onsets[a:b], L, bl)
        got_rows = table[a:b].cpu()
        raw_ulps = max(raw_ulps, ulp_distance(got_rows, want_rows))
        windows = wg.window_gather_plain(rec_cpu.reshape(S * NT, Cx, T),
                                         rec_ids[a:b], onsets[a:b], L)
        scale = max_abs_ulp(windows.abs().amax(dim=-1)).repeat(1, 2)
        window_ulps = max(window_ulps,
                          float(((got_rows - want_rows).abs() / scale).max()))
    if not window_ulps <= 2.0:
        raise AssertionError(f"sweep card vs CPU: {window_ulps} ulps of the "
                             "window's max |x|")

    # the sweep chunk's two kernels at their shapes, timed
    chunk_gather = gather_case(ds.recordings.reshape(S * NT, Cx, T),
                               SWEEP_CHUNK, L, 8, None, flush)
    Xc = wg.window_gather(ds.recordings.reshape(S * NT, Cx, T),
                          rec_ids[:SWEEP_CHUNK].cuda(), onsets[:SWEEP_CHUNK].cuda(), L)
    Xc = Xc - Xc[..., :bl].mean(-1, keepdim=True)
    chunk_quant = quantile_checks(Xc.reshape(-1, L).contiguous(), flush)
    del Xc
    emit({"phase": "presets", "kernel": "window_gather", "at": "sweep chunk",
          **chunk_gather})
    emit({"phase": "presets", "kernel": "robust_quantiles", "at": "sweep chunk",
          **chunk_quant})
    # the preset step's kernels at B = 256: the X and the bf16 Y gathers, BN
    # in bf16 (its collate launches no quantile kernel)
    B256 = 4 * BATCH
    b256 = {"X": gather_case(ds.recordings.reshape(S * NT, Cx, T), B256, L, 9,
                             None, flush),
            "Y bf16": gather_case(ds.y_stream, B256, L, 10, torch.bfloat16, flush)}
    for k, c in b256.items():
        emit({"phase": "presets", "kernel": "window_gather", "at": f"B=256 {k}", **c})
    bn256 = bn_rows(*bn_inputs(torch.Generator(device="cuda").manual_seed(11),
                               B256, D2, L, torch.bfloat16), flush, "presets")

    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    rng = np.random.RandomState(seed + 3)
    loc = ch_locations_2d(cfg)
    out = {"sweep_s": sweep_s, "chunk_gather": chunk_gather,
           "chunk_quantiles": chunk_quant, "b256_gather": b256,
           "b256_bn": bn256, "launches": {}}
    for preset in PRESETS:
        pcfg = compose(CONFIGS_DIR, preset, [
            f"cache_dir={cfg.cache_dir}", f"seed={seed}", "epochs=1",
            f"updates={PRESET_UPDATES}", f"run_name={preset}",
            f"save_root={os.path.join(work, preset)}"])
        pcfg.num_subjects = ds.num_subjects
        B = int(pcfg.batch_size)
        loss_cfg = dataclasses.replace(train_speech.loss_config(pcfg),
                                       grad_norms=True)
        pcollate = evaluate_speech.collate_config(pcfg)

        def fresh():
            model = get_model(pcfg, loc, device=dev, seed=seed, num_channels=Cx)
            opt = make_optimizer(pcfg, PRESET_UPDATES)
            return model, opt, create_train_state(
                model, opt, float(pcfg.init_temperature), seed)

        # one batch's collate, cached vs inline
        idx = pool.segment_ids(rng.randint(0, len(pool), B))
        sess = torch.randint(0, S, (B,), generator=torch.Generator().manual_seed(seed))
        X = gather_speech_batch(ds, idx, sess_ids=sess)[0]
        seg = torch.as_tensor(ds.segment_table()[idx], device=dev)
        rows = collate_stats_rows(ds, table, seg[:, 0], seg[:, 1], sess.to(dev))
        inline = collate_preprocess(X, bl, pcollate.clamp_lim, pcollate.clamp)
        cached = collate_preprocess_cached(X, rows[:, :Cx], rows[:, Cx:], bl,
                                           pcollate.clamp_lim, pcollate.clamp)
        collate_ulps = ulp_distance(cached, inline)
        if collate_ulps > 2:
            raise AssertionError(f"{preset}: cached vs inline collate "
                                 f"{collate_ulps} ulp apart")
        del X, inline, cached
        # the first step from one state and batch, cached vs inline
        centre = int(torch.randint(Cx, (), generator=torch.Generator().manual_seed(seed)))
        first = []
        for stats in (table, None):
            model, opt, state = fresh()
            fused = make_fused_speech_step(model, opt, loss_cfg, pcollate, ds,
                                           collate_stats=stats)
            _, m = fused(state, idx, sess_ids=sess, centre=centre)
            first.append(float(m["loss"]))
            del model, opt, state, fused
        loss_rel = abs(first[0] - first[1]) / abs(first[1])
        if not loss_rel <= 1e-5:
            raise AssertionError(f"{preset}: first loss cached {first[0]} vs "
                                 f"inline {first[1]}")
        # a few fused steps with the cached statistics, timed
        model, opt, state = fresh()
        fused = make_fused_speech_step(model, opt, loss_cfg, pcollate, ds,
                                       collate_stats=table)
        step_ms, losses = [], []
        for i in range(PRESET_STEPS):
            sidx = pool.segment_ids(rng.randint(0, len(pool), B))
            gen = torch.Generator().manual_seed(seed * 1000 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fused(state, sidx, generator=gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            if float(m["skipped"]) != 0.0 or not math.isfinite(losses[-1]):
                raise AssertionError(f"{preset} step {i}: loss {losses[-1]}, "
                                     f"skipped {float(m['skipped'])}")
        del model, opt, state, fused

        # the main path: the train CLI with the preset, one epoch
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train_speech.run(Config(to_dict(pcfg)), device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = all_launches()
        n_test = len(ds) - len(tr_idx)
        pools = len(_test_pool_starts(
            n_test, min(n_test, int(pcfg.get("test_size", B))),
            bool(pcfg.get("test_sweep", True))))
        # the sweep; per update 2 gathers and 20 BN kernels, no quantile
        # launch; per test pool 2 gathers and the inline collate's quantiles
        expected = {"window_gather": n_chunks + 2 * (PRESET_UPDATES + pools),
                    "robust_quantiles": n_chunks + pools,
                    "bn_stats": BN_PER_STEP * PRESET_UPDATES,
                    "bn_bwd_stats": BN_PER_STEP * PRESET_UPDATES}
        if launches != expected:
            raise AssertionError(f"{preset} CLI launches {launches}, "
                                 f"expected {expected}")
        if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
            raise AssertionError(f"{preset} CLI: {best}")
        out["launches"][preset] = launches
        out[preset] = {"steady_step_ms": float(np.median(step_ms[1:]))}
        emit({"phase": "presets", "preset": preset,
              "compute_dtype": str(pcfg.compute_dtype), "batch_size": B,
              "gelu": str(pcfg.get("gelu_impl") or
                          ("tanh" if pcfg.get("gelu_approximate") else "erf")),
              "sweep_s": sweep_s, "sweep_windows": total,
              "sweep_chunks": n_chunks, "sweep_launches": sweep_launches,
              "table_shape": list(table.shape),
              "table_bytes": table.numel() * table.element_size(),
              "table_vs_cpu_chunks": chunks, "table_vs_cpu_max_ulp": raw_ulps,
              "table_vs_cpu_window_ulps": window_ulps,
              "table_limit": "2 ulp of the window channel's max |x|",
              "collate_cached_vs_inline_ulp": collate_ulps,
              "collate_bit_identical": collate_ulps == 0,
              "first_loss_cached": first[0], "first_loss_inline": first[1],
              "first_loss_rel_err": loss_rel, "first_loss_limit": 1e-5,
              "first_step_ms": step_ms[0], "step_ms": step_ms,
              "steady_step_ms": float(np.median(step_ms[1:])), "losses": losses,
              "train_cli_s": run_s, "test_pools": pools, "launches": launches,
              "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                                 "test_loss", "test_top10")}})
    return out


def compare_epochs(run_epoch, run_steps) -> dict:
    """The epoch form against the per-step path, both from one init and
    draws, cuDNN deterministic (the same kernels on the same inputs), run
    in turns (epoch, per-step, per-step, epoch; the first run pays the
    deterministic algorithms' set-up): mean loss within 1e-5 relative,
    every state entry within 1e-5 of its tensor's max |p|, for every run
    against the first epoch."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        times = {"epoch": [], "per_step": []}
        results = []
        for kind, run in (("epoch", run_epoch), ("per_step", run_steps),
                          ("per_step", run_steps), ("epoch", run_epoch)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, means = run()
            means = {k: float(v) for k, v in means.items()}
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            results.append((model, means))
    finally:
        torch.backends.cudnn.deterministic = prev
    m_a, a = results[0]
    loss_rel = p_rel = 0.0
    for m_b, b in results[1:]:
        loss_rel = max(loss_rel, abs(a["loss"] - b["loss"]) / abs(b["loss"]))
        p_rel = max(p_rel, params_rel_err(m_a, m_b))
        if b["skipped"] != 0.0:
            raise AssertionError(f"a step was skipped: {b}")
    if not (loss_rel <= 1e-5 and p_rel <= 1e-5 and a["skipped"] == 0.0
            and math.isfinite(a["loss"])):
        raise AssertionError(f"epoch vs per-step: {[r[1] for r in results]}, "
                             f"params {p_rel}")
    return {"epoch_s": times["epoch"], "per_step_s": times["per_step"],
            "epoch_means": a, "per_step_means": results[1][1],
            "loss_rel_err": loss_rel, "params_rel_err": p_rel, "limit": 1e-5}


def phase_scan_speech(cfg, ds, tr_idx, seed, work) -> dict:
    """One speech epoch of SCAN_UPDATES updates, the epoch form
    (``make_gwilliams_scan_epoch``) against the fused step one update at a
    time, on the same segment ids and sessions; then the main path: the
    train CLI with ``use_scan_epochs`` on the sentence split.  Returns its
    launch counts."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    loss_cfg = train_speech.loss_config(cfg)
    collate = evaluate_speech.collate_config(cfg)
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    rng = np.random.RandomState(seed + 5)
    idx = np.stack([pool.segment_ids(rng.randint(0, len(pool), BATCH))
                    for _ in range(SCAN_UPDATES)])
    sess = torch.randint(0, ds.num_sessions, (SCAN_UPDATES, BATCH),
                         generator=torch.Generator().manual_seed(seed + 6))

    def fresh():
        model = get_model(cfg, loc, device=dev, seed=seed,
                          num_channels=int(ds.recordings.shape[2]))
        opt = make_optimizer(cfg, SCAN_UPDATES)
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    def run_epoch():
        model, opt, state = fresh()
        epoch = make_gwilliams_scan_epoch(model, opt, loss_cfg, collate, ds,
                                          SCAN_UPDATES, BATCH)
        return model, epoch(state, idx=torch.as_tensor(idx, device=dev),
                            sess_ids=sess.to(dev))[1]

    def run_steps():
        model, opt, state = fresh()
        fused = make_fused_speech_step(model, opt, loss_cfg, collate, ds)
        hist = [fused(state, idx[u], sess_ids=sess[u])[1]
                for u in range(SCAN_UPDATES)]
        return model, epoch_means(hist, SCAN_UPDATES)

    check = compare_epochs(run_epoch, run_steps)

    # the main path: the train CLI, one scan epoch on the sentence split
    out = os.path.join(work, "scan_out")
    tcfg = compose(CONFIGS_DIR, "config", [
        f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
        f"batch_size={BATCH}", "epochs=1", f"updates={SCAN_UPDATES}",
        "split_mode=sentence", "use_scan_epochs=true", "run_name=scan"])
    n_test = len(evaluate_speech.load_gwilliams_splits(
        Config(to_dict(tcfg)), seed, "cpu")[1])
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_speech.run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    pools = len(_test_pool_starts(n_test, min(n_test, BATCH),
                                  bool(tcfg.get("test_sweep", True))))
    expected = {"window_gather": 2 * (SCAN_UPDATES + pools),
                "robust_quantiles": SCAN_UPDATES + pools,
                "bn_stats": BN_PER_STEP * SCAN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * SCAN_UPDATES}
    if launches != expected:
        raise AssertionError(f"scan CLI launches {launches}, expected {expected}")
    if best.get("train_skipped") != 0.0 or "t_step_ms" in best:
        raise AssertionError(f"scan CLI: {best}")
    emit({"phase": "scan_epochs", "workload": "speech", "updates": SCAN_UPDATES,
          "batch_size": BATCH, **check, "train_cli_s": run_s,
          "test_pools": pools, "launches": launches,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")}})
    return launches


def phase_scan_god(cfg, ds, seed) -> dict:
    """One GOD epoch of SCAN_UPDATES updates, ``make_scan_epoch`` against
    the per-step form on the same indices; then the main path:
    ``cli/train_god.py`` with ``use_scan_epochs``.  Returns its launch
    counts."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg, roi(cfg))
    loss_cfg = train_god._loss_config(cfg)
    collate = evaluate_speech.collate_config(cfg)
    idx = torch.randint(0, len(ds), (SCAN_UPDATES, BATCH),
                        generator=torch.Generator().manual_seed(seed + 8))

    def fresh():
        model = get_model(cfg, loc, device=dev, seed=seed, num_channels=len(loc))
        opt = make_optimizer(cfg, SCAN_UPDATES)
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    def run_epoch():
        model, opt, state = fresh()
        epoch = make_scan_epoch(model, opt, loss_cfg, collate, ds,
                                SCAN_UPDATES, BATCH)
        return model, epoch(state, idx=idx.to(dev))[1]

    def run_steps():
        model, opt, state = fresh()
        step = make_train_step(model, opt, loss_cfg, collate)
        hist = [step(state, *ds.gather(idx[u])[:3])[1]
                for u in range(SCAN_UPDATES)]
        return model, epoch_means(hist, SCAN_UPDATES)

    check = compare_epochs(run_epoch, run_steps)

    tcfg = Config(to_dict(cfg))
    tcfg.use_scan_epochs = True
    tcfg.updates = SCAN_UPDATES
    tcfg.save_root = os.path.join(cfg.save_root, "scan")
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_god.run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    n_train = int(round(len(ds) * 5 / 6))
    pools = len(_test_pool_starts(len(ds) - n_train,
                                  min(len(ds) - n_train, int(cfg.test_size)),
                                  bool(cfg.get("test_sweep", True))))
    expected = {"window_gather": 1, "robust_quantiles": SCAN_UPDATES + pools,
                "bn_stats": BN_PER_STEP * SCAN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * SCAN_UPDATES}
    if launches != expected:
        raise AssertionError(f"GOD scan CLI launches {launches}, expected {expected}")
    if best.get("train_skipped") != 0.0 or "t_step_ms" in best:
        raise AssertionError(f"GOD scan CLI: {best}")
    emit({"phase": "scan_epochs", "workload": "god", "updates": SCAN_UPDATES,
          "batch_size": BATCH, **check, "train_cli_s": run_s,
          "test_pools": pools, "launches": launches,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")}})
    return launches


def phase_model_zoo(god_cfg, god_ds, seed, flush) -> dict:
    """The GOD train CLI with ``model=eegnet`` at config_GOD.yaml's EEGNet
    hyper-parameters, then ``model=brain_endcoder_seq2static`` with
    ``window.end=0.6`` (T = 48) at D1 = 270, D2 = 320, F = 512; for each,
    the first step on the card against the CPU (loss and global gradient
    norm within 1e-4; EEGNet's dropout masks come from the state's CPU
    generator, the same on both); then the BN kernels at EEGNet's three
    shapes and Seq2Static's five.  Returns each CLI's launch counts."""
    dev = torch.device("cuda")
    launches_by_model, rows = {}, {}
    for name, window_end, n_bn in (("eegnet", None, EEGNET_BN),
                                   ("brain_endcoder_seq2static", 0.6, BN_PER_STEP)):
        zcfg = Config(to_dict(god_cfg))
        zcfg.model = name
        zcfg.save_root = os.path.join(god_cfg.save_root, name)
        if window_end is not None:
            zcfg.window.end = window_end
        ds = god_ds if window_end is None else build_god_dataset(
            zcfg, "train", device="cuda")
        zcfg.num_subjects = ds.num_subjects
        loc = ch_locations_2d(zcfg, roi(zcfg))
        loss_cfg = dataclasses.replace(train_god._loss_config(zcfg), grad_norms=True)
        collate = evaluate_speech.collate_config(zcfg)

        def state_on(device):
            model = get_model(zcfg, loc, device=device, seed=seed,
                              num_channels=len(loc))
            opt = make_optimizer(zcfg, int(zcfg.updates))
            return model, opt, create_train_state(
                model, opt, float(zcfg.init_temperature), seed)

        model, opt, state = state_on(dev)
        cpu_model, cpu_opt, cpu_state = state_on("cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        X, Y, subs, _ = ds.gather(np.arange(BATCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = make_train_step(model, opt, loss_cfg, collate)(
            state, X, Y, subs, centre=0)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        _, mc = make_train_step(cpu_model, cpu_opt, loss_cfg, collate)(
            cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=0)
        check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
                 "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
                 "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
            raise AssertionError(f"{name}: card vs CPU train step: {check}")
        del model, opt, state, cpu_model, cpu_opt, cpu_state

        # the main path: the GOD train CLI, one epoch of the cv split
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train_god.run(Config(to_dict(zcfg)), device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = all_launches()
        n_train = int(round(len(ds) * 5 / 6))
        updates = n_train // BATCH
        pools = len(_test_pool_starts(len(ds) - n_train,
                                      min(len(ds) - n_train, int(zcfg.test_size)),
                                      bool(zcfg.get("test_sweep", True))))
        expected = {"window_gather": 1, "robust_quantiles": updates + pools,
                    "bn_stats": n_bn * updates, "bn_bwd_stats": n_bn * updates}
        if launches != expected:
            raise AssertionError(f"{name} CLI launches {launches}, expected {expected}")
        if best.get("train_skipped") != 0.0 or not (
                math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
            raise AssertionError(f"{name} CLI: {best}")
        launches_by_model[name] = launches
        emit({"phase": "model_zoo", "model": name, "T": int(ds.X.shape[2]),
              "card_vs_cpu": check, "rel_err_limit": 1e-4,
              "first_step_ms": first_ms, "train_cli_s": run_s,
              "updates": updates, "test_pools": pools, "launches": launches,
              "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                                 "test_loss", "test_top10",
                                                 "t_step_ms")}})
        if window_end is not None:
            del ds

    # the BN kernels at the new shapes: EEGNet's three (timed) and
    # Seq2Static's five (T = 48 → 23 → 11 → 5 → 2; the first timed)
    gen = torch.Generator(device="cuda").manual_seed(9)
    Cr = int(god_ds.X.shape[1])
    T = int(god_ds.X.shape[2])
    for Cc, Tt in ((16, Cr * T), (32, T), (32, T // 2), (D2, 48)):
        rows[f"{BATCH}x{Cc}x{Tt}"] = bn_rows(*bn_inputs(gen, BATCH, Cc, Tt, torch.float32),
                                     flush, "model_zoo")
    for Tt in (23, 11, 5, 2):
        bn_check(*bn_inputs(gen, BATCH, D2, Tt, torch.float32), cotangents=True)
    return {"launches": launches_by_model, "bn": rows}


# Brennan2018 at the scale of the real dataset: 33 usable subjects × 60
# EEG channels × a 742 s (12.4 min) audiobook recording at 500 Hz, a
# 1024-wide embedding stream at 120 Hz (89,040 samples): rows of 88,920
# keys a subject's channel after the shift and the trim, 33 times that
# pooled
BRENNAN = dict(S=33, C=60, fs=500.0, rec_sec=742.0, F=1024, rate=120.0)
BRENNAN_DATA_RTOL = 1e-5   # card vs CPU: f32 FFTs of 371,000 samples, two libraries
BRENNAN_CHECK_SUBJECTS = 3
BRENNAN_CLI = dict(n_subjects=6, C=60, rec_sec=120.0, F=1024)
BRENNAN_UPDATES = 4


def brennan_launches() -> dict:
    return {**all_launches(), "robust_quantiles_long": qk.long_launches}


def brennan_raw_on_card(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(X_raw (S, C, T) f32 at 500 Hz, Y (F, T_y) f32 at 120 Hz) on the
    card from ``seed``, as ``make_synthetic_brennan_raw`` composes them
    (each subject's EEG a random channel mix of the stream brought to the
    EEG rate, plus noise) without writing ~3 GB of .mat files."""
    b = BRENNAN
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, Ty = int(b["fs"] * b["rec_sec"]), int(b["rate"] * b["rec_sec"])
    Y = torch.randn(b["F"], Ty, device="cuda", generator=g)
    Y_up = resample_fft(Y, up=T / Ty)
    mix = torch.randn(b["S"], b["C"], b["F"], device="cuda", generator=g) * 0.5
    X = torch.einsum("scf,ft->sct", mix, Y_up)
    del Y_up
    X += 0.1 * torch.randn(X.shape, device="cuda", generator=g)
    return X, Y


def brennan_cfg(seed: int, overrides=()) -> Config:
    """``configs/config.yaml`` with ``dataset=Brennan2018``: 60 channels on
    the easycap layout, D1 = 270, D2 = 320, K = 32, 5 blocks, seq2seq,
    F = 1024 (``last4layers``), 3 s segments at 120 Hz, B = 64."""
    return compose(CONFIGS_DIR, "config", [
        "dataset=Brennan2018", f"seed={seed}", f"batch_size={BATCH}",
        *overrides])


def long_quantile_case(x2d: torch.Tensor, flush, what: str) -> dict:
    """The long-row path on (N, T) rows with the hard rows: against the
    plain version (≤ 1 ulp), timed as the other kernels are.  The bound is
    one read of the rows (the function's least traffic); the radix select
    reads them once a pass, 4 times (``design_floor_ms``)."""
    N, T = x2d.shape
    if qk.kernel_route(T) != "global":
        raise AssertionError(f"{what}: rows of {T} keys do not take the "
                             "global-memory path")
    x2d = with_hard_rows(x2d)
    before = qk.long_launches
    got, want, ulps = quantile_check(x2d)
    if qk.long_launches != before + 1:
        raise AssertionError(f"{what}: the long-row kernel did not launch")
    fin = torch.isfinite(got) & torch.isfinite(want)
    q_lib = torch.tensor([0.25, 0.5, 0.75], device="cuda")
    lib_ms, lib_note = library_time(
        lambda: torch.quantile(x2d, q_lib, dim=1), flush)
    nbytes = N * T * 4 + N * 3 * 4
    row = {"at": what, "shape": [N, T], "tolerance": "<= 1 ulp",
           "max_ulp": ulps,
           "max_abs_err": float((got[fin] - want[fin]).abs().max()),
           "kernel_ms": time_ms(lambda: qk.robust_quantiles(x2d), flush,
                                reps=10),
           "run_ms": run_ms([lambda x=x: qk.robust_quantiles(x)
                             for x in copies(x2d, nbytes)], n=16, reps=3),
           "plain_ms": time_ms(lambda: qk.robust_quantiles_plain(x2d), flush,
                               reps=5),
           "library_ms": lib_ms, "library_refused": lib_note,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes",
           "design_floor_ms": 4 * N * T * 4 / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "brennan_kernels", "kernel": "robust_quantiles_long", **row})
    return row


def phase_brennan_kernels(row_len: int, flush) -> dict:
    """The quantile kernel's global-memory path against its plain version
    on the card: hard rows at T = 58,113 (just past the shared-memory
    path), Brennan's subject-wise rows (S·C rows of ``row_len``) and its
    pooled rows (C rows of S·``row_len``)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    S, Cb = BRENNAN["S"], BRENNAN["C"]
    out = {}
    for what, shape in (("T=58113", (BATCH, qk.SHARED_MAX_T + 1)),
                        ("subject-wise", (S * Cb, row_len)),
                        ("pooled", (Cb, S * row_len))):
        out[what] = long_quantile_case(
            torch.randn(shape, device="cuda", generator=g), flush, what)
    return out


def phase_brennan_data(seed: int):
    """The Brennan build on the card at the real scale, subject-wise and
    pooled (the quantile kernel's long rows), each against the CPU on a
    3-subject subset.  Returns (the subject-wise dataset, its row length,
    the build's launches)."""
    t0 = time.perf_counter()
    X_raw, Y = brennan_raw_on_card(seed)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    fs = BRENNAN["fs"]
    out, launches = {}, {}
    ds = None
    for sw in (True, False):
        cfg = brennan_cfg(seed, [f"preprocs.subject_wise={str(sw).lower()}"])
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = build_brennan_dataset(cfg, Y, X_raw, fs, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        mode = "subject_wise" if sw else "pooled"
        launches[mode] = brennan_launches()
        want = {"window_gather": 0, "robust_quantiles": 0, "bn_stats": 0,
                "bn_bwd_stats": 0, "robust_quantiles_long": 1}
        if launches[mode] != want:
            raise AssertionError(f"Brennan build ({mode}) launches "
                                 f"{launches[mode]}, expected {want}")
        if not bool(torch.isfinite(built.X).all()):
            raise AssertionError(f"Brennan build ({mode}): X not finite")
        # card against CPU on the first subjects (the same host arithmetic)
        n = BRENNAN_CHECK_SUBJECTS
        sub_card = build_brennan_dataset(cfg, Y, X_raw[:n], fs, device="cuda")
        t0 = time.perf_counter()
        sub_cpu = build_brennan_dataset(cfg, Y.cpu(), X_raw[:n].cpu(), fs,
                                        device="cpu")
        cpu_s = time.perf_counter() - t0
        err = float((sub_card.X.cpu() - sub_cpu.X).abs().max())
        peak = float(sub_cpu.X.abs().max())
        if not (err <= BRENNAN_DATA_RTOL * peak
                and torch.equal(sub_card.Y.cpu(), sub_cpu.Y)):
            raise AssertionError(f"Brennan build ({mode}) card vs CPU: "
                                 f"max|ΔX| {err}, max|X| {peak}")
        out[mode] = {"card_build_s": card_s, "X": list(built.X.shape),
                     "Y": list(built.Y.shape),
                     "X_bytes": built.X.numel() * 4,
                     "Y_bytes": built.Y.numel() * 4,
                     "cpu_check": {"subjects": n, "cpu_build_s": cpu_s,
                                   "max_abs_err": err, "max_abs_X": peak,
                                   "limit": f"{BRENNAN_DATA_RTOL} * max|X|"},
                     "launches": launches[mode]}
        del sub_card, sub_cpu
        if sw:
            ds = built
        else:
            del built
    row_len = int(ds.X.shape[0] * ds.X.shape[3])
    del X_raw, Y
    emit({"phase": "brennan_data", "raw": [BRENNAN["S"], BRENNAN["C"],
                                          int(fs * BRENNAN["rec_sec"])],
          "fs": fs, "rec_sec": BRENNAN["rec_sec"], "make_on_card_s": make_s,
          "row_keys": row_len, "pooled_row_keys": BRENNAN["S"] * row_len,
          **out, "reduced": "none: 33 subjects as the real dataset keeps "
                            "after its exclusions; synthetic EEG"})
    return ds, row_len, launches


def phase_brennan_training(ds, seed: int) -> dict:
    """The unfused step at the full width (``brennan_cfg``) on the built
    dataset: the first step on the card against the CPU (loss and global
    gradient norm within 1e-4), then the steady step time and device
    operations a step (``profile_train_step.profile_config``).  Returns
    the launch counts of the timed steps."""
    dev = torch.device("cuda")
    cfg = brennan_cfg(seed)
    cfg.num_subjects, cfg.num_channels = ds.num_subjects, int(ds.X.shape[2])
    loc = ch_locations_2d(cfg)
    loss_cfg = dataclasses.replace(train_speech.loss_config(cfg), grad_norms=True)
    collate = evaluate_speech.collate_config(cfg)
    if collate.enabled:
        raise AssertionError("Brennan's step must run without the collate")

    def train_state(device):
        model = get_model(cfg, loc, device=device, seed=seed,
                          num_channels=cfg.num_channels)
        opt = make_optimizer(cfg, int(cfg.updates))
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    model, opt, state = train_state(dev)
    cpu_model, cpu_opt, cpu_state = train_state("cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pool = evaluate_speech.SpeechPool(ds, seed=seed)
    X, Y, subs = pool.gather(np.arange(BATCH) % len(pool))
    step = make_train_step(model, opt, loss_cfg, collate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, X, Y, subs, centre=0)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _, mc = make_train_step(cpu_model, cpu_opt, loss_cfg, collate)(
        cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=0)
    check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
             "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
        raise AssertionError(f"card vs CPU Brennan train step: {check}")
    del cpu_model, cpu_opt, cpu_state

    rng = np.random.RandomState(seed)

    def one(i):
        idx = rng.randint(0, len(pool), BATCH)
        return step(state, *pool.gather(
            idx, generator=torch.Generator().manual_seed(i)))[1]

    reset_all_launches()
    prof = profile_config(cfg, one, warmup=2, steps=5)
    launches = brennan_launches()
    emit({"phase": "brennan_training", "card_vs_cpu": check,
          "rel_err_limit": 1e-4, "first_step_ms": first_ms,
          "steady_step_ms": prof["step_ms_median"], "step_ms": prof["step_ms"],
          "device_ops_per_step": prof["device_ops_per_step"],
          "busy_ms_per_step": prof["busy_ms_per_step"],
          "idle_share_of_window": prof["idle_share_of_window"],
          "groups_ms_per_step": prof["groups_ms_per_step"],
          "width": {"C": cfg.num_channels, "S": cfg.num_subjects,
                    "D1": int(cfg.D1), "D2": int(cfg.D2), "K": int(cfg.K),
                    "F": int(Y.shape[1]), "T": int(X.shape[2]), "B": BATCH},
          "launches": launches})
    return {"launches": launches, "steady_step_ms": prof["step_ms_median"]}


def phase_brennan_cli(work: str, seed: int) -> dict:
    """The main path on Brennan: ``make_synthetic_brennan_raw`` (6 subjects
    × 60 channels × 120 s at 500 Hz, F = 1024), the train CLI for one
    epoch of BRENNAN_UPDATES updates with the subjects pooled for the
    robust scale (rows of 6 × 14,040 = 84,240 keys: the long-row path), then the
    eval CLI on its checkpoint.  Returns the launch counts of each."""
    root = os.path.join(work, "brennan")
    t0 = time.perf_counter()
    make_synthetic_brennan_raw(root, seed=seed, **BRENNAN_CLI)
    write_s = time.perf_counter() - t0
    out = os.path.join(work, "brennan_out")
    overrides = [f"root_dir={root}", f"save_root={out}", "epochs=1",
                 f"updates={BRENNAN_UPDATES}", "run_name=smoke",
                 "preprocs.subject_wise=false"]
    result = {}
    for name, cli in (("train", train_speech), ("eval", evaluate_speech)):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.run(brennan_cfg(seed, overrides), device="cuda")
        torch.cuda.synchronize()
        result[name] = {"seconds": time.perf_counter() - t0,
                        "launches": brennan_launches(), "result": res}
    best, ev = result["train"]["result"], result["eval"]["result"]
    if best.get("train_skipped") != 0.0 or not (
            math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
        raise AssertionError(f"Brennan train CLI: {best}")
    if not (0.0 <= ev["test_top1"] <= ev["test_top10"] <= 1.0
            and math.isfinite(ev["pairwise_correlation"])):
        raise AssertionError(f"Brennan eval CLI: {ev}")
    # one long-row launch a build; BN kernels in training only, 10 an update
    want = {"train": {"window_gather": 0, "robust_quantiles": 0,
                      "bn_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "bn_bwd_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "robust_quantiles_long": 1},
            "eval": {"window_gather": 0, "robust_quantiles": 0, "bn_stats": 0,
                     "bn_bwd_stats": 0, "robust_quantiles_long": 1}}
    for name in want:
        if result[name]["launches"] != want[name]:
            raise AssertionError(f"Brennan {name} CLI launches "
                                 f"{result[name]['launches']}, expected {want[name]}")
    emit({"phase": "brennan_cli", "write_s": write_s, **BRENNAN_CLI,
          "updates": BRENNAN_UPDATES, "train_cli_s": result["train"]["seconds"],
          "eval_cli_s": result["eval"]["seconds"],
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")},
          "eval": ev, "launches": {k: r["launches"] for k, r in result.items()}})
    return {k: r["launches"] for k, r in result.items()}


def phase_unfused_step(cfg, ds, tr_idx, seed, work) -> dict:
    """Gwilliams with ``fuse_gather: false``: the unfused first step (the
    pool's gather, then ``make_train_step``) against the fused step on the
    same segments and sessions (loss and global gradient norm within
    1e-5), then the main path: the train CLI for one epoch with
    ``fuse_gather=false``.  Returns its launch counts."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    loss_cfg = dataclasses.replace(train_speech.loss_config(cfg), grad_norms=True)
    collate = evaluate_speech.collate_config(cfg)
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    idx = np.random.RandomState(seed + 3).randint(0, len(pool), BATCH)
    metrics = {}
    for kind in ("fused", "unfused"):  # the same weights: one seed
        m_k = get_model(cfg, loc, device=dev, seed=seed)
        opt = make_optimizer(cfg, int(cfg.updates))
        state = create_train_state(m_k, opt, float(cfg.init_temperature), seed)
        gen = torch.Generator().manual_seed(seed + 4)
        if kind == "fused":
            step = make_fused_speech_step(m_k, opt, loss_cfg, collate, ds)
            _, metrics[kind] = step(state, pool.segment_ids(idx),
                                    generator=gen, centre=0)
        else:
            step = make_train_step(m_k, opt, loss_cfg, collate)
            _, metrics[kind] = step(state, *pool.gather(idx, generator=gen),
                                    centre=0)
    check = {k: rel_err(metrics["unfused"][k], metrics["fused"][k])
             for k in ("loss", "grad_norm")}
    if not all(v <= 1e-5 for v in check.values()):
        raise AssertionError(f"unfused vs fused step: {check}")

    out = os.path.join(work, "unfused_out")
    tcfg = compose(CONFIGS_DIR, "config", [
        f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
        f"batch_size={BATCH}", "epochs=1", f"updates={TRAIN_UPDATES}",
        "fuse_gather=false", "run_name=unfused"])
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_speech.run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    n_test = len(ds) - len(tr_idx)
    pools = len(_test_pool_starts(n_test, min(n_test, BATCH),
                                  bool(tcfg.get("test_sweep", True))))
    # as the fused path: per update 2 gathers, 1 collate, 10 + 10 BN
    # kernels; per test pool 2 gathers and 1 collate
    expected = {"window_gather": 2 * (TRAIN_UPDATES + pools),
                "robust_quantiles": TRAIN_UPDATES + pools,
                "bn_stats": BN_PER_STEP * TRAIN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * TRAIN_UPDATES}
    if launches != expected:
        raise AssertionError(f"unfused CLI launches {launches}, expected {expected}")
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"unfused CLI: {best}")
    emit({"phase": "unfused_step", "rel_err": check, "limit": 1e-5,
          "loss": float(metrics["fused"]["loss"]), "train_cli_s": run_s,
          "test_pools": pools, "launches": launches,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10",
                                             "t_gather_ms", "t_step_ms")}})
    return launches


# --- the stimulus encoders, the cache builder, error analysis, entry points --

FEATURE_RTOL = 1e-4        # card vs CPU: 24 f32 layers, cuDNN/cuBLAS vs MKL sums
W2V_CLIP_SEC, W2V_CHUNKED_SEC, W2V_LONG_SEC = 3.0, 45.0, 742.0
GOD_IMAGES, GOD_IMAGE_HW, CLIP_CHECK_IMAGES = 1250, (375, 500), 8
GW_REC = dict(C=208, T=360_000, fs=1000.0)  # one 6-minute recording
GW_CHECK_T = 60_000
GW_BUILD_Y_SEC = (25.0, 30.0, 35.0, 40.0)   # one file a task prefix
BRENNAN_AUDIO = dict(sr=44_100, files=2)     # 120 s in all (BRENNAN_CLI)
DISTRACTORS = 50_000                         # ImageNet-val's size


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got − want| / max|want|, on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def w2v_flops(cfg, n_samples: int, layers: bool = True) -> float:
    """Operations (2 per multiply-add) of one wav2vec2 forward over
    ``n_samples``: the conv stack, and with ``layers`` the projection, the
    positional conv and the encoder layers (attention over all frames)."""
    flops, n, c_in = 0.0, n_samples, 1
    for c_out, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
        flops += 2.0 * n * c_out * c_in * k
        c_in = c_out
    if not layers:
        return flops
    H, T = cfg.hidden_size, n
    flops += 2.0 * T * c_in * H
    flops += 2.0 * T * H * (H // cfg.num_conv_pos_embedding_groups) \
        * cfg.num_conv_pos_embeddings
    per_layer = 2.0 * T * (4 * H * H + 2 * H * cfg.intermediate_size) \
        + 4.0 * T * T * H
    return flops + cfg.num_hidden_layers * per_layer


def clip_flops(cfg, n_images: int) -> float:
    """Operations of ``get_image_features`` over ``n_images``."""
    H, P = cfg.hidden_size, cfg.num_positions
    patch = 2.0 * (P - 1) * H * cfg.num_channels * cfg.patch_size ** 2
    per_layer = 2.0 * P * (4 * H * H + 2 * H * cfg.intermediate_size) \
        + 4.0 * P * P * H
    return n_images * (patch + cfg.num_hidden_layers * per_layer
                       + 2.0 * H * cfg.projection_dim)


def write_wav(path: str, sr: int, seconds: float, seed: int) -> None:
    from scipy.io import wavfile

    w = 0.1 * np.random.RandomState(seed).randn(int(sr * seconds))
    wavfile.write(path, sr, w.astype(np.float32))


def phase_w2v_features(seed: int) -> dict:
    """wav2vec2-large-xlsr-53 with seeded random weights: every hidden
    state of one 3 s clip on the card against the same weights on the CPU,
    a 2-layer copy's chunked, masked last-4 average over 45 s against the
    CPU, then the full model over 742 s of 16 kHz audio (Brennan's
    length): the last-4 average and the conv features, timed."""
    from meg_decoding_tpu_torch.features import wav2vec
    from meg_decoding_tpu_torch.features.wav2vec2_model import Wav2Vec2Model

    def cpu_copy(model):
        cpu = Wav2Vec2Model(model.config)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        return cpu.eval().requires_grad_(False)

    g = torch.Generator(device="cuda").manual_seed(seed)
    audio = lambda sec: 0.1 * torch.randn(int(16000 * sec), device="cuda",
                                          generator=g)
    t0 = time.perf_counter()
    model = wav2vec.load_wav2vec(backend="random", device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    clip = audio(W2V_CLIP_SEC)
    with torch.no_grad():
        card = model(clip[None])
        cpu_states = cpu_copy(model)(clip[None].cpu())
    clip_errs = [max_rel(a, b) for a, b in zip(card, cpu_states)]
    del cpu_states
    if len(card) != 25 or not max(clip_errs) <= FEATURE_RTOL:
        raise AssertionError(f"wav2vec2 hidden states card vs CPU: {clip_errs}")

    shallow = wav2vec.load_wav2vec(backend="random", num_hidden_layers=2,
                                   device="cuda", seed=seed)
    long_clip = audio(W2V_CHUNKED_SEC)
    got = wav2vec.embed_last4_avg(shallow, long_clip)
    t0 = time.perf_counter()
    want = wav2vec.embed_last4_avg(cpu_copy(shallow), long_clip.cpu())
    cpu_chunked_s = time.perf_counter() - t0
    chunked_err = max_rel(got, want)
    n_chunked = int(shallow.config.num_frames(long_clip.numel()))
    if got.shape != (1024, n_chunked) or not chunked_err <= FEATURE_RTOL:
        raise AssertionError(f"chunked last-4 card vs CPU: {chunked_err}, "
                             f"{tuple(got.shape)}")
    del shallow, got, want

    wav = audio(W2V_LONG_SEC)
    chunks = []  # the samples of each forward the last-4 average runs
    forward = model.forward
    model.forward = lambda x, *a, **k: (chunks.append(x.shape[-1]),
                                        forward(x, *a, **k))[1]
    out = {}
    for name, fn in (("last4", wav2vec.embed_last4_avg),
                     ("features", wav2vec.embed_features)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        emb = fn(model, wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"wav2vec2 {name} over {W2V_LONG_SEC} s: not finite")
        flops = (sum(w2v_flops(model.config, n) for n in chunks) if name == "last4"
                 else w2v_flops(model.config, wav.numel(), layers=False))
        bound_s = flops / F32_FLOP_PER_S
        out[name] = {"shape": list(emb.shape), "seconds": sec,
                     "frames_per_s": emb.shape[1] / sec,
                     "audio_s_per_s": W2V_LONG_SEC / sec,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "tflop": flops / 1e12, "bound_s": bound_s,
                     "bound_by": "operations (f32, TF32 off)",
                     "share_of_bound": bound_s / sec}
        del emb
    out["last4"]["chunks"] = len(chunks)
    model.forward = forward
    frames = int(model.config.num_frames(wav.numel()))
    if out["last4"]["shape"] != [1024, frames] or out["features"]["shape"] != [512, frames]:
        raise AssertionError(f"wav2vec2 shapes {out}")
    del model, wav
    torch.cuda.empty_cache()
    row = {"phase": "w2v_features", "params": n_params, "init_s": init_s,
           "clip_sec": W2V_CLIP_SEC, "clip_hidden_states": len(card),
           "clip_max_rel_err": max(clip_errs),
           "chunked": {"layers": 2, "sec": W2V_CHUNKED_SEC,
                       "frames": n_chunked, "max_rel_err": chunked_err,
                       "cpu_s": cpu_chunked_s},
           "rel_err_limit": FEATURE_RTOL, "long_sec": W2V_LONG_SEC,
           "frames": frames, **out}
    emit(row)
    return row


def phase_clip_features(seed: int) -> dict:
    """ViT-B/32 with seeded random weights: ``preprocess_images`` and
    ``encode_images`` over GOD's 1,250 images (1,200 train, 50 test) of
    375 × 500 made on the card, timed; then 8 of them card against CPU."""
    from meg_decoding_tpu_torch.features import clip_features
    from meg_decoding_tpu_torch.features.clip_model import CLIPImageEncoder

    model = clip_features.load_clip(backend="random", device="cuda", seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (GOD_IMAGES, *GOD_IMAGE_HW, 3),
                           dtype=torch.uint8, device="cuda", generator=g)
    clip_features.encode_images(model, clip_features.preprocess_images(
        images[:64], device="cuda"))  # first calls: cuBLAS/cuDNN set-up
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pixels = clip_features.preprocess_images(images, device="cuda")
    torch.cuda.synchronize()
    times["preprocess_s"] = time.perf_counter() - t0
    feats = clip_features.encode_images(model, pixels)
    torch.cuda.synchronize()
    times["encode_s"] = time.perf_counter() - t0 - times["preprocess_s"]
    if feats.shape != (GOD_IMAGES, 512) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"CLIP features {tuple(feats.shape)}")
    cpu = CLIPImageEncoder(model.config)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    few = images[:CLIP_CHECK_IMAGES].cpu()
    cpu_pixels = clip_features.preprocess_images(few, device="cpu")
    pixel_err = float((pixels[:CLIP_CHECK_IMAGES].cpu() - cpu_pixels).abs().max())
    feat_err = max_rel(feats[:CLIP_CHECK_IMAGES],
                       clip_features.encode_images(cpu.eval(), cpu_pixels))
    if not (pixel_err <= 1e-5 and feat_err <= FEATURE_RTOL):
        raise AssertionError(f"CLIP card vs CPU: pixels {pixel_err}, "
                             f"features {feat_err}")
    total = times["preprocess_s"] + times["encode_s"]
    flops = clip_flops(model.config, GOD_IMAGES)
    row = {"phase": "clip_features", "images": GOD_IMAGES,
           "image_hw": list(GOD_IMAGE_HW), **times, "seconds": total,
           "images_per_s": GOD_IMAGES / total,
           "encode_tflop": flops / 1e12,
           "encode_bound_s": flops / F32_FLOP_PER_S,
           "encode_share_of_bound": flops / F32_FLOP_PER_S / times["encode_s"],
           "card_vs_cpu": {"images": CLIP_CHECK_IMAGES,
                           "pixels_max_abs_err": pixel_err,
                           "features_max_rel_err": feat_err,
                           "limits": {"pixels": 1e-5, "features": FEATURE_RTOL}}}
    del model, images, pixels, feats
    torch.cuda.empty_cache()
    emit(row)
    return row


def phase_gwilliams_preprocess(work: str, seed: int) -> dict:
    """``preprocess_recordings`` on one Gwilliams recording (208 × 360,000
    samples at 1000 Hz, 1–60 Hz, then 120 Hz), timed; 208 × 60,000 of it
    card against CPU; then the cache builder's ``main`` on synthetic
    stimulus audio for the four task prefixes (wav2vec2 at full width,
    random weights): ``check_preprocs`` picks the directory whose settings
    match, ``build_y`` writes ``y_dict.npy``."""
    from meg_decoding_tpu_torch.cli import build_gwilliams_cache
    from meg_decoding_tpu_torch.data.gwilliams import preprocess_recordings
    from meg_decoding_tpu_torch.utils.cache import check_preprocs, mark_done

    pre = compose(CONFIGS_DIR, "config").preprocs
    band = (float(pre.brain_filter_low), float(pre.brain_filter_high),
            float(pre.brain_resample_rate))
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(GW_REC["C"], GW_REC["T"], device="cuda", generator=g)
    rec_s = []  # the first call makes the FFT plans of this length
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = preprocess_recordings(X, GW_REC["fs"], *band, device="cuda")
        torch.cuda.synchronize()
        rec_s.append(time.perf_counter() - t0)
    want_T = resample_len(GW_REC["T"], down=GW_REC["fs"] / band[2])
    if out.shape != (GW_REC["C"], want_T) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"Gwilliams preprocess {tuple(out.shape)}")
    part = X[:, :GW_CHECK_T]
    card = preprocess_recordings(part, GW_REC["fs"], *band, device="cuda").cpu()
    cpu = preprocess_recordings(part.cpu(), GW_REC["fs"], *band, device="cpu")
    err, peak = float((card - cpu).abs().max()), float(cpu.abs().max())
    if not err <= 1e-5 * peak:
        raise AssertionError(f"Gwilliams preprocess card vs CPU: {err} > 1e-5·{peak}")
    del X, out

    root = os.path.join(work, "gwilliams_build")
    audio = os.path.join(root, "data", "Gwilliams2022", "stimuli", "audio")
    os.makedirs(audio)
    for t, (prefix, sec) in enumerate(zip(build_gwilliams_cache.TASK_PREFIXES,
                                          GW_BUILD_Y_SEC)):
        write_wav(os.path.join(audio, f"{prefix}_0.wav"), 16000, sec, seed + t)
    argv = [f"root_dir={root}", "+wav2vec_backend=random"]
    cfg = build_gwilliams_cache.parse_cli(argv)
    base = os.path.join(root, "data", "Gwilliams2022", "preprocessed")
    other, _, _ = check_preprocs({**to_dict(cfg.preprocs),
                                  "brain_resample_rate": 100}, base)
    mine, _, _ = check_preprocs(to_dict(cfg.preprocs), base)
    mark_done(mine, "x_done")  # the MEG half needs mne_bids: not here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chosen = build_gwilliams_cache.main(["--device", "cuda", *argv])
    torch.cuda.synchronize()
    build_y_s = time.perf_counter() - t0
    y = np.load(os.path.join(chosen, "y_dict.npy"), allow_pickle=True).item()
    shapes = {k: list(v.shape) for k, v in sorted(y.items())}
    want = {f"task{t}": [1024, int(round(sec * band[2]))]
            for t, sec in enumerate(GW_BUILD_Y_SEC)}
    if chosen != mine or chosen == other or shapes != want \
            or not all(np.isfinite(v).all() for v in y.values()):
        raise AssertionError(f"cache builder: {chosen} (want {mine}), {shapes}")
    row = {"phase": "gwilliams_preprocess",
           "recording": [GW_REC["C"], GW_REC["T"]], "fs": GW_REC["fs"],
           "band_hz": band[:2], "rate_hz": band[2],
           "bytes": GW_REC["C"] * GW_REC["T"] * 4, "first_s": rec_s[0],
           "seconds": min(rec_s[1:]),
           "card_vs_cpu": {"shape": [GW_REC["C"], GW_CHECK_T],
                           "max_abs_err": err, "max_abs_X": peak,
                           "limit": "1e-5 * max|X|"},
           "build_y": {"audio_s": list(GW_BUILD_Y_SEC), "seconds": build_y_s,
                       "y_dict": shapes,
                       "cache_dir": os.path.relpath(chosen, root),
                       "other_settings_dir": os.path.relpath(other, root)}}
    emit(row)
    return row


def phase_brennan_embed_cli(work: str, seed: int) -> dict:
    """Both speech CLIs on Brennan with its audio and no stream: the
    ``brennan_cli`` set-up (6 subjects × 60 channels × 120 s) plus 120 s
    of synthetic audio at 44.1 kHz in two files.  The train CLI embeds the
    audio at full width (wav2vec2 last-4 average, random weights), writes
    the stream and trains one epoch; the eval CLI reuses the stream.
    Returns the launch counts of each."""
    root = os.path.join(work, "brennan_embed")
    make_synthetic_brennan_raw(root, seed=seed, **BRENNAN_CLI)
    y_path = os.path.join(root, "data", "Brennan2018", "Y_embeds",
                          "embd_wav2vec.npy")
    os.remove(y_path)
    audio = os.path.join(root, "data", "Brennan2018", "audio")
    os.makedirs(audio)
    n = BRENNAN_AUDIO["files"]
    for i in range(n):
        write_wav(os.path.join(audio, f"DownTheRabbitHoleFinal_SoundFile{i + 1}.wav"),
                  BRENNAN_AUDIO["sr"], BRENNAN_CLI["rec_sec"] / n, seed + i)
    overrides = [f"root_dir={root}", f"save_root={os.path.join(work, 'be_out')}",
                 "epochs=1", f"updates={BRENNAN_UPDATES}", "run_name=smoke",
                 "preprocs.subject_wise=false", "+wav2vec_backend=random"]
    result, mtime = {}, None
    for name, cli in (("train", train_speech), ("eval", evaluate_speech)):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.run(brennan_cfg(seed, overrides), device="cuda")
        torch.cuda.synchronize()
        result[name] = {"seconds": time.perf_counter() - t0,
                        "launches": brennan_launches(), "result": res}
        if mtime is None:
            mtime = os.path.getmtime(y_path)
    stream = np.load(y_path)
    frames = int(round(BRENNAN_CLI["rec_sec"] * BRENNAN["rate"]))
    if stream.shape != (1024, frames) or not np.isfinite(stream).all():
        raise AssertionError(f"Brennan stream {stream.shape}")
    if os.path.getmtime(y_path) != mtime:
        raise AssertionError("the eval CLI embedded the audio again")
    best, ev = result["train"]["result"], result["eval"]["result"]
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"Brennan train CLI (embedding): {best}")
    if not (0.0 <= ev["test_top1"] <= ev["test_top10"] <= 1.0):
        raise AssertionError(f"Brennan eval CLI (embedding): {ev}")
    want = {"train": {"window_gather": 0, "robust_quantiles": 0,
                      "bn_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "bn_bwd_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "robust_quantiles_long": 1},
            "eval": {"window_gather": 0, "robust_quantiles": 0, "bn_stats": 0,
                     "bn_bwd_stats": 0, "robust_quantiles_long": 1}}
    for name in want:
        if result[name]["launches"] != want[name]:
            raise AssertionError(f"Brennan {name} CLI (embedding) launches "
                                 f"{result[name]['launches']}, expected {want[name]}")
    emit({"phase": "brennan_embed_cli", "audio_s": BRENNAN_CLI["rec_sec"],
          "audio_hz": BRENNAN_AUDIO["sr"], "stream": list(stream.shape),
          "train_cli_s": result["train"]["seconds"],
          "eval_cli_s": result["eval"]["seconds"],
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")},
          "eval": ev, "launches": {k: r["launches"] for k, r in result.items()}})
    return {k: r["launches"] for k, r in result.items()}


def phase_god_error_analysis(cfg, work: str, seed: int) -> dict:
    """The GOD eval CLI with ``error_analysis: true`` on the train CLI's
    checkpoint: without distractors (``top5.csv``) and with a synthetic
    50,000 × 512 ImageNet-val gallery (``top5_with_imagenet_val.csv``).
    Returns the launch counts of each run."""
    dpath = os.path.join(work, "imagenet_val_features.npy")
    np.save(dpath, np.random.RandomState(seed + 2).randn(
        DISTRACTORS, FULL_WIDTH_GOD["feat_dim"]).astype(np.float32))
    out, launches = {}, {}
    for name, csv_name, extra in (
            ("val", "top5.csv", {}),
            ("imagenet_val", "top5_with_imagenet_val.csv",
             {"imagenet_val_features_path": dpath})):
        ecfg = Config({**to_dict(cfg), "error_analysis": True,
                       "save_root": os.path.join(work, f"god_error_{name}"),
                       "ckpt_dir": os.path.join(cfg.save_root, "ckpt"), **extra})
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_god.run(ecfg, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[name] = all_launches()
        with open(os.path.join(ecfg.save_root, csv_name)) as f:
            rows = f.read().splitlines()
        if len(rows) != 1 + FULL_WIDTH_GOD["n_test"] or not all(
                0.0 <= res[k] <= 1.0 for k in ("similarity_acc", "mean_acc_scene")):
            raise AssertionError(f"GOD error analysis ({name}): {res}, "
                                 f"{len(rows)} CSV rows")
        expected = {"window_gather": 2, "robust_quantiles": 1, "bn_stats": 0,
                    "bn_bwd_stats": 0}
        if launches[name] != expected:
            raise AssertionError(f"GOD error analysis ({name}) launches "
                                 f"{launches[name]}, expected {expected}")
        out[name] = {"seconds": sec, "csv": csv_name, "csv_rows": len(rows) - 1,
                     **{k: res[k] for k in ("similarity_acc", "mean_acc_scene")}}
    emit({"phase": "god_error_analysis", "distractors": DISTRACTORS, **out,
          "launches": launches})
    return launches


def phase_entry_points(cfg, work: str) -> dict:
    """``train_main`` and ``evaluate_main`` (``train_torch.py``,
    ``evaluate_torch.py``) on the full-width GOD set-up for 2 updates, then
    a 2-job ``-m`` sweep over the seed.  Returns the launch counts of each."""
    import yaml

    from meg_decoding_tpu_torch.cli import main as entry

    cfg_dir = os.path.join(work, "entry_cfg")
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "god_entry.yaml"), "w") as f:
        yaml.safe_dump({**to_dict(cfg), "save_root": os.path.join(work, "entry_out"),
                        "run_name": "entry", "use_sampler": True,
                        "updates": 2, "epochs": 1}, f)
    argv = ["--device", "cuda", "--config-path", cfg_dir,
            "--config-name", "god_entry"]
    result = {}
    for name, fn, args in (("train", entry.train_main, argv),
                           ("evaluate", entry.evaluate_main, argv),
                           ("sweep", entry.train_main, ["-m", *argv, "seed=0,1"])):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(args)
        torch.cuda.synchronize()
        result[name] = {"seconds": time.perf_counter() - t0,
                        "launches": all_launches(), "result": res}
    best, ev, jobs = (result[k]["result"] for k in ("train", "evaluate", "sweep"))
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"train_main: {best}")
    if set(ev) != GOD_EVAL_KEYS:
        raise AssertionError(f"evaluate_main: {ev}")
    sweep = os.path.join(work, "entry_out", "multirun")
    stamps = os.listdir(sweep)
    job_dirs = [os.path.join(sweep, stamps[0], str(i)) for i in range(2)]
    if len(jobs) != 2 or len(stamps) != 1 or any("error" in r for r in jobs) \
            or not all(os.path.exists(os.path.join(d, "ckpt", "model_best.pt"))
                       for d in job_dirs):
        raise AssertionError(f"sweep: {stamps}, {jobs}")
    per_update = {"bn_stats": BN_PER_STEP * 2, "bn_bwd_stats": BN_PER_STEP * 2}
    for name, k in (("train", 1), ("sweep", 2)):
        got = result[name]["launches"]
        if any(got[b] != k * n for b, n in per_update.items()) \
                or got["window_gather"] != k or got["robust_quantiles"] < 3 * k:
            raise AssertionError(f"{name} launches {got}")
    if result["evaluate"]["launches"] != {"window_gather": 2, "robust_quantiles": 1,
                                          "bn_stats": 0, "bn_bwd_stats": 0}:
        raise AssertionError(f"evaluate_main launches {result['evaluate']['launches']}")
    emit({"phase": "entry_points", "updates": 2,
          **{f"{k}_s": r["seconds"] for k, r in result.items()},
          "train": {k: best[k] for k in ("train_loss", "train_skipped", "test_loss")},
          "sweep_jobs": [os.path.relpath(d, work) for d in job_dirs],
          "launches": {k: r["launches"] for k, r in result.items()}})
    return {k: r["launches"] for k, r in result.items()}


# --- the serving artifact, the export CLI, checkpoint import, host spill ------

SERVE_BATCHES = (1, 7, 8, 64)   # odd and even, past one and at the step's
BENCH_BATCHES, BENCH_ITERS = (1, 8, 64), 30
EXPORT_RTOL = 1e-5    # artifact vs eager forward on the card, · max|ref|
CARD_CPU_RTOL = 1e-4  # card vs CPU: cuDNN vs MKL f32 sums, as `serving`
SPILL_STEPS = 6       # the timed steps of each form (the first untimed)
SPILL_RTOL = 1e-5     # spill vs device-resident: the same kernels and draws
QUANTILE_OP = torch.ops.meg_decoding_tpu_torch.robust_quantiles.default


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got − want| / max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def serve_case(name, model, n_channels, seq_len, n_subjects, collate, seed,
               work) -> dict:
    """One encoder: export on the card, load on the card and on the CPU,
    served against the eager forward, the CPU artifact, its launches, a
    scaled weight and the latency rows."""
    dev = torch.device("cuda")
    out = os.path.join(work, f"artifact_{name}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_artifact(out, model, n_channels, seq_len, collate,
                  extra_meta={"num_subjects": n_subjects})
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = load_artifact(out, device="cuda")
    cpu = load_artifact(out, device="cpu")
    load_s = time.perf_counter() - t0
    n_ops = sum(1 for n in card.program.graph.nodes if n.target is QUANTILE_OP)
    if n_ops != 1 or card.program.state_dict:
        raise AssertionError(f"{name} artifact: {n_ops} quantile ops, "
                             f"{len(card.program.state_dict)} weights inside")
    forward = make_serving_forward(collate)
    rng = np.random.RandomState(seed)

    def request(B):
        X = torch.from_numpy(rng.randn(B, n_channels, seq_len)
                             .astype(np.float32)).to(dev)
        subs = torch.from_numpy(rng.randint(0, n_subjects, B)
                                .astype(np.int32)).to(dev)
        return X, subs

    errs = {}
    for B in SERVE_BATCHES:
        X, subs = request(B)
        Z, ref = card(X, subs), forward(model, X, subs)
        if Z.shape != ref.shape or Z.shape[0] != B or not bool(torch.isfinite(Z).all()):
            raise AssertionError(f"{name} artifact at B = {B}: {tuple(Z.shape)}")
        errs[B] = rel_max(Z, ref)
        if not errs[B] <= EXPORT_RTOL:
            raise AssertionError(f"{name} artifact vs eager at B = {B}: {errs[B]}")
    X, subs = request(8)
    cpu_err = rel_max(card(X, subs).cpu(), cpu(X.cpu(), subs.cpu()))
    if not cpu_err <= CARD_CPU_RTOL:
        raise AssertionError(f"{name} card vs CPU artifact: {cpu_err}")
    # one served request launches the hand-written percentiles once
    X, subs = request(BATCH)
    torch.cuda.synchronize()
    reset_all_launches()
    Z = card(X, subs)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != {"window_gather": 0, "robust_quantiles": 1, "bn_stats": 0,
                    "bn_bwd_stats": 0} or qk.long_launches != 0:
        raise AssertionError(f"{name} artifact call launches {launches}")
    key = "conv_final2.weight"
    w = card.weights[key]
    card.weights[key] = w * 1.5
    scaled = card(X, subs)
    card.weights[key] = w
    if torch.equal(scaled, Z):
        raise AssertionError(f"{name}: a weight scaled by 1.5 left Z as it was")
    rows = []
    for B in BENCH_BATCHES:
        X, subs = request(B)
        for source, call in (("eager", lambda x, s: forward(model, x, s)),
                             ("artifact", card)):
            rows.append({"source": source,
                         **latency_row(call, X, subs, BENCH_ITERS, dev)})
    sizes = {f: os.path.getsize(os.path.join(out, f))
             for f in ("forward.pt2", "weights.pt", "meta.json")}
    return {"input": [n_channels, seq_len], "subjects": n_subjects,
            "export_s": export_s, "load_s": load_s, "rel_err": errs,
            "limit": EXPORT_RTOL, "card_vs_cpu_rel_err": cpu_err,
            "card_vs_cpu_limit": CARD_CPU_RTOL, "launches": launches,
            "file_bytes": sizes, "latency": rows}


def phase_serving_export(cfg, god_cfg, god_ds, seed, work) -> dict:
    """The serving artifact at full width: the Gwilliams seq2seq encoder
    (collate on) and the GOD encoder at config_GOD.yaml's widths.  Returns
    each artifact call's launch counts."""
    dev = torch.device("cuda")
    speech = get_model(cfg, ch_locations_2d(cfg), device=dev, seed=seed)
    god_loc = ch_locations_2d(god_cfg, roi(god_cfg))
    god = get_model(god_cfg, god_loc, device=dev, seed=seed,
                    num_channels=len(god_loc))
    cases = {
        "speech": serve_case("speech", speech, C, int(cfg.preprocs.brain_resample_rate
                                                    * cfg.preprocs.seq_len_sec),
                             int(cfg.num_subjects),
                             evaluate_speech.collate_config(cfg), seed, work),
        "god": serve_case("god", god, len(god_loc), int(god_ds.X.shape[-1]),
                          int(god_ds.num_subjects),
                          evaluate_speech.collate_config(god_cfg), seed, work)}
    emit({"phase": "serving_export", **cases})
    return {f"artifact_serve_{k}": v["launches"] for k, v in cases.items()}


def phase_export_cli(cfg, god_cfg, seed, work) -> dict:
    """``train_speech`` and ``train_god`` for 2 updates each, then
    ``cli/export_model.py`` on each checkpoint; the artifact served on the
    card against the evaluator's eager forward on the same checkpoint.
    Returns the launch counts of export + one served request."""
    from meg_decoding_tpu_torch.cli.export_model import (
        export_checkpoint_path,
        run as export_run,
    )

    dev = torch.device("cuda")
    out_speech = os.path.join(work, "export_speech")
    overrides = [f"cache_dir={cfg.cache_dir}", f"save_root={out_speech}",
                 f"seed={seed}", f"batch_size={BATCH}", "epochs=1", "updates=2",
                 "run_name=export"]
    god = dict(to_dict(god_cfg), save_root=os.path.join(work, "export_god"),
               updates=2, use_sampler=True, epochs=1, run_name="export")
    result = {}
    for name in ("speech", "god"):
        t0 = time.perf_counter()
        if name == "speech":
            train_speech.run(compose(CONFIGS_DIR, "config", overrides), device="cuda")
            ecfg = compose(CONFIGS_DIR, "config", overrides)
            test_set = evaluate_speech.load_speech_splits(ecfg, seed, dev)[1]
            ecfg.num_subjects, ecfg.num_channels = (test_set.num_subjects,
                                                    test_set.num_channels)
            model = get_model(ecfg, ch_locations_2d(ecfg), device=dev, seed=seed,
                              num_channels=ecfg.num_channels)
            model.load_state_dict(evaluate_speech.load_model_state(
                export_checkpoint_path(ecfg)[0], dev))
            X, _, subs = test_set.gather(np.arange(BATCH))
            ref = make_serving_forward(evaluate_speech.collate_config(ecfg))(
                model, X, subs)
            expected = {"window_gather": 0, "robust_quantiles": 1,
                        "bn_stats": 0, "bn_bwd_stats": 0}
        else:
            train_god.run(Config(god), device="cuda")
            ecfg = Config(god)
            _, val, model = evaluate_god._build(ecfg, dev)
            model.load_state_dict(evaluate_speech.load_model_state(
                export_checkpoint_path(ecfg)[0], dev))
            n = min(BATCH, len(val))
            sub = val.subset(np.arange(n))
            ref = evaluate_god.predict(ecfg, model, sub, batch_size=n)
            X, _, subs = sub.gather(np.arange(n))[:3]
            # the export builds the GOD train split for its shapes: one gather
            expected = {"window_gather": 1, "robust_quantiles": 1,
                        "bn_stats": 0, "bn_bwd_stats": 0}
        train_s = time.perf_counter() - t0
        ecfg = (compose(CONFIGS_DIR, "config", overrides) if name == "speech"
                else Config(god))
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        art = export_run(ecfg, device="cuda")
        export_s = time.perf_counter() - t0
        served = load_artifact(art, device="cuda")
        Z = served(X, subs)
        torch.cuda.synchronize()
        launches = all_launches()
        if launches != expected:
            raise AssertionError(f"export CLI {name}: launches {launches}, "
                                 f"expected {expected}")
        err = rel_max(Z, ref)
        if not err <= EXPORT_RTOL or served.meta["checkpoint"] != "model_best":
            raise AssertionError(f"export CLI {name}: artifact vs evaluator "
                                 f"{err}, meta {served.meta}")
        result[name] = {"train_and_reference_s": train_s, "export_s": export_s,
                        "rel_err": err, "limit": EXPORT_RTOL,
                        "meta": {k: served.meta[k] for k in (
                            "input", "checkpoint", "dataset", "num_subjects",
                            "custom_ops")},
                        "launches": launches}
    emit({"phase": "export_cli", **result})
    return {f"export_cli_{k}": v["launches"] for k, v in result.items()}


def reference_state_dict(sd: dict) -> dict:
    """A port ``BrainEncoder`` state_dict under the reference's module names
    and layouts (``meg_decoding/models.py:340-361``): the inverse of
    ``utils/torch_import.py:brain_encoder_from_state_dict``."""
    ref = {"subject_block.spatial_attention.z": torch.complex(
        sd["subject_block.spatial_attention.z_re"],
        sd["subject_block.spatial_attention.z_im"])}
    for name in ("subject_block.conv", "conv_final1", "conv_final2"):
        ref[f"{name}.weight"] = sd[f"{name}.weight"][:, :, None]
        ref[f"{name}.bias"] = sd[f"{name}.bias"]
    for s, w in enumerate(sd["subject_block.subject_layer.weight"]):
        ref[f"subject_block.subject_layer.{s}.weight"] = w.T[:, :, None]
    k = 0
    while f"conv{k}.conv0.weight" in sd:
        blk, out = f"conv{k}", f"conv_blocks.conv{k}"
        for c in ("conv0", "conv1"):
            ref[f"{out}.{c}.weight"] = sd[f"{blk}.{c}.weight"]
            ref[f"{out}.{c}.bias"] = sd[f"{blk}.{c}.bias"]
        for p in ("weight", "bias"):
            ref[f"{out}.conv2.{p}"] = torch.cat([sd[f"{blk}.conv2a.{p}"],
                                                 sd[f"{blk}.conv2b.{p}"]])
        for i in (0, 1):
            bn, rbn = f"{blk}.bn{i}", f"{out}.batchnorm{i}"
            ref[f"{rbn}.weight"], ref[f"{rbn}.bias"] = sd[f"{bn}.scale"], sd[f"{bn}.bias"]
            ref[f"{rbn}.running_mean"] = sd[f"{bn}.mean"]
            ref[f"{rbn}.running_var"] = sd[f"{bn}.var"]
            ref[f"{rbn}.num_batches_tracked"] = torch.tensor(0)
        k += 1
    return {k_: v.detach().cpu().contiguous() for k_, v in ref.items()}


def phase_torch_import(cfg, seed, work) -> dict:
    """A full-width Gwilliams encoder written as a reference-named
    checkpoint, imported (``utils/torch_import.py``) and served on the card:
    bit-identical to the model it came from.  Returns the launches of the
    imported model's request."""
    from meg_decoding_tpu_torch.utils.torch_import import (
        brain_encoder_from_state_dict,
        load_torch_checkpoint,
    )

    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    model = get_model(cfg, loc, device=dev, seed=seed)
    path = os.path.join(work, "reference_model_last.pt")
    torch.save(reference_state_dict(model.state_dict()), path)
    t0 = time.perf_counter()
    sd = brain_encoder_from_state_dict(load_torch_checkpoint(path))
    imported = get_model(cfg, loc, device=dev, seed=seed + 1)
    imported.load_state_dict(sd)
    import_s = time.perf_counter() - t0
    for k, v in model.state_dict().items():
        if not torch.equal(imported.state_dict()[k], v):
            raise AssertionError(f"torch_import: {k} differs after the round trip")
    rng = np.random.RandomState(seed + 7)
    seq_len = int(cfg.preprocs.brain_resample_rate * cfg.preprocs.seq_len_sec)
    X = torch.from_numpy(rng.randn(BATCH, C, seq_len).astype(np.float32)).to(dev)
    subs = torch.from_numpy(rng.randint(0, int(cfg.num_subjects), BATCH)).to(dev)
    forward = make_serving_forward(evaluate_speech.collate_config(cfg))
    ref = forward(model, X, subs)
    torch.cuda.synchronize()
    reset_all_launches()
    Z = forward(imported, X, subs)
    torch.cuda.synchronize()
    launches = all_launches()
    if not torch.equal(Z, ref) or launches["robust_quantiles"] != 1:
        raise AssertionError(f"torch_import: served Z differs "
                             f"({rel_max(Z, ref)}) or launches {launches}")
    emit({"phase": "torch_import", "entries": len(sd), "import_s": import_s,
          "bit_identical": True, "Z_shape": list(Z.shape), "launches": launches})
    return launches


def same_draw_runs(make_state, batches_device, batches_spill) -> dict:
    """SPILL_STEPS unfused steps on the device-resident batches and on the
    spilled ones (host gathers through ``prefetch_to_device``), the same
    draws and init, cuDNN deterministic: losses and every state entry
    within SPILL_RTOL; the wall time a step of each, its first step
    untimed, one synchronize at the end."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for kind, batches in (("device", batches_device), ("spill", batches_spill)):
            model, state, step = make_state()
            losses = []
            for i, batch in enumerate(batches()):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, m = step(state, *batch)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            out[kind] = (model, [float(v) for v in losses],
                         (time.perf_counter() - t0) * 1e3 / (len(losses) - 1))
    finally:
        torch.backends.cudnn.deterministic = prev
    (dm, dl, dt), (sm, sl, st) = out["device"], out["spill"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sl, dl))
    p_rel = params_rel_err(sm, dm)
    if len(sl) != len(dl) or not (loss_rel <= SPILL_RTOL and p_rel <= SPILL_RTOL):
        raise AssertionError(f"spill vs device: losses {sl} / {dl}, params {p_rel}")
    return {"steps": len(dl), "device_step_ms": dt, "spill_step_ms": st,
            "losses": dl, "loss_rel_err": loss_rel, "params_rel_err": p_rel,
            "limit": SPILL_RTOL}


def spill_cli(run, tcfg, work, name, expected) -> dict:
    """A train CLI with ``host_resident: true, prefetch: 2`` and the epoch
    traced: exact launches, and a trace holding the port's kernels and a
    host-to-device copy on a stream other than the kernels'."""
    prof = os.path.join(work, f"profile_{name}")
    tcfg.host_resident, tcfg.prefetch = True, 2
    tcfg.profile_dir, tcfg.profile_epoch = prof, 0
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = run(tcfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = all_launches()
    if launches != expected:
        raise AssertionError(f"{name} spill CLI launches {launches}, "
                             f"expected {expected}")
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"{name} spill CLI: {best}")
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies_h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and "HtoD" in str(e.get("name"))]
    ours = {"robust_quantiles": 0, "bn_stats": 0, "bn_bwd": 0}
    for e in kernels:
        for k in ours:
            ours[k] += k in e["name"]
    streams = lambda es: sorted({e.get("args", {}).get("stream") for e in es})  # noqa: E731
    compute = {e.get("args", {}).get("stream") for e in kernels
               if "bn_stats" in e["name"]}
    side = [e for e in copies_h2d if e.get("args", {}).get("stream") not in compute]
    if not all(ours.values()) or not side:
        raise AssertionError(f"{name} trace: kernels {ours}, H2D copies on "
                             f"{streams(copies_h2d)}, kernels on {sorted(compute)}")
    return {"train_cli_s": run_s, "launches": launches,
            "trace": {"events": len(events), "port_kernels": ours,
                      "h2d_copies": len(copies_h2d), "h2d_off_compute": len(side),
                      "h2d_streams": streams(copies_h2d),
                      "compute_streams": sorted(compute)},
            "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                               "test_loss", "t_gather_ms",
                                               "t_step_ms")}}


def direct_quantiles(x2d, qs=(25.0, 50.0, 75.0)):
    """The kernel's launch called directly, past the registered op."""
    return qk._launch(x2d, tuple(qs))


def route_cost(make_state, batches: list) -> dict:
    """What the registered op costs the collate against a direct call of
    the same launch: the host time of one call on a (8, 24) block (the
    kernel a few µs; 400 calls, one synchronize), and the wall time of an
    unfused step on ``batches`` (device-resident) with the collate's
    percentiles through each route, in blocks op, direct, direct, op after
    one untimed pass."""
    from meg_decoding_tpu_torch.ops import scaling

    routes = {"op": qk.robust_quantiles, "direct": direct_quantiles}
    tiny = torch.randn(8, 24, device="cuda")
    _, state, step = make_state()
    dispatch = {k: [] for k in routes}
    step_ms = {k: [] for k in routes}
    try:
        for i, name in enumerate(("op", "direct", "direct", "op")):
            scaling.robust_quantiles = routes[name]
            for _ in range(1 if i else 2):  # the first block warms up first
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for batch in batches:
                    state, _ = step(state, *batch)
                torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / len(batches))
            fn = routes[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(400):
                fn(tiny)
            torch.cuda.synchronize()
            dispatch[name].append((time.perf_counter() - t0) * 1e6 / 400)
    finally:
        scaling.robust_quantiles = qk.robust_quantiles
    return {"steps": len(batches), "step_ms": step_ms, "call_us": dispatch}


def busy_ms(spans) -> float:
    """Milliseconds covered by the union of (start µs, duration µs) spans."""
    total, end = 0.0, -math.inf
    for ts, dur in sorted(spans):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total / 1e3


def traced_steps(make_state, batches, path: str) -> dict:
    """The steps of ``batches()`` (its first untimed) under torch.profiler,
    the trace written to ``path``, split per step: wall time; the host
    thread that launches the kernels (the compute thread), its time inside
    operators and outside them (Python, waits); the card's busy time
    (kernels and copies)."""
    from torch.profiler import ProfilerActivity, profile

    _, state, step = make_state()
    it = iter(batches())
    state, _ = step(state, *next(it))
    torch.cuda.synchronize()
    n = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in it:
            state, _ = step(state, *batch)
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]
    launches = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "LaunchKernel" in str(e.get("name")):
            launches[e["tid"]] = launches.get(e["tid"], 0) + 1
    compute = max(launches, key=launches.get, default=None)
    ops = busy_ms((e["ts"], e["dur"]) for e in events
                  if e.get("cat") == "cpu_op" and e["tid"] == compute)
    on_card = busy_ms((e["ts"], e["dur"]) for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return {"step_ms": wall_ms / n, "compute_thread_ops_ms": ops / n,
            "compute_thread_other_ms": (wall_ms - ops) / n,
            "device_busy_ms": on_card / n, "steps": n}


def producer_timed(batches, spent: list):
    """``batches``' items; the thread CPU and wall seconds that making each
    took, appended to ``spent``."""
    it = iter(batches)
    while True:
        c0, w0 = time.thread_time(), time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        spent.append((time.thread_time() - c0, time.perf_counter() - w0))
        yield item


def spill_split(make_state, batches_device, host_batches, work, name) -> dict:
    """``traced_steps`` of the device-resident run and of the spill run
    (``host_batches()`` through ``prefetch_to_device``), with the spill
    producer's thread CPU and wall time per batch (the profiler traces the
    compute thread's operators only)."""
    spent = []
    out = {"device": traced_steps(make_state, batches_device,
                                  os.path.join(work, f"split_{name}_device.json")),
           "spill": traced_steps(
               make_state,
               lambda: prefetch_to_device(producer_timed(host_batches(), spent),
                                          size=2, device="cuda"),
               os.path.join(work, f"split_{name}_spill.json"))}
    out["spill"]["producer_cpu_ms"] = sum(c for c, _ in spent) * 1e3 / len(spent)
    out["spill"]["producer_wall_ms"] = sum(w for _, w in spent) * 1e3 / len(spent)
    return out


def phase_spill_speech(cfg, seed, work, unfused_launches) -> dict:
    """The speech spill path at full width (the `training` phase's cache,
    B = 64): unfused steps on host-gathered batches through the prefetch
    against the device-resident unfused steps on the same draws, then the
    train CLI with ``host_resident``: no gather launch, the other kernels
    as the unfused CLI launched them.  Returns the CLI's launches."""
    from meg_decoding_tpu_torch.cli.train_speech import spill_speech_splits
    from meg_decoding_tpu_torch.ops.kernels.window_gather import padded_window
    from meg_decoding_tpu_torch.train.loop import derived_generator

    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    loss_cfg = train_speech.loss_config(cfg)
    collate = evaluate_speech.collate_config(cfg)
    train_pool, test_pool = evaluate_speech.load_speech_splits(
        Config(to_dict(cfg)), seed, dev)
    ds = train_pool.ds
    L, T = int(ds.seq_len), int(ds.recordings.shape[-1])
    on = ds.meg_onsets
    between = int(((on > T - padded_window(L)) & (on <= T - L)).sum())
    rng = np.random.RandomState(seed + 8)
    draws = [rng.randint(0, len(train_pool), BATCH) for _ in range(SPILL_STEPS + 1)]

    def make_state():
        model = get_model(cfg, loc, device=dev, seed=seed)
        opt = make_optimizer(cfg, SPILL_STEPS + 1)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        return model, state, make_train_step(model, opt, loss_cfg, collate)

    def gathered():
        for i, idx in enumerate(draws):
            yield train_pool.gather(idx, generator=derived_generator(seed, 0, 2, i))

    # the device-resident form first, then the same pools spilled
    device_ds, spilled = train_pool.ds, {}

    def batches_device():
        train_pool.ds = device_ds
        return gathered()

    def host_batches():
        if not spilled:
            spill_speech_splits(train_pool, test_pool)
            spilled["ds"] = train_pool.ds
        train_pool.ds = spilled["ds"]
        return gathered()

    def batches_spill():
        return prefetch_to_device(host_batches(), size=2, device=dev)

    check = same_draw_runs(make_state, batches_device, batches_spill)
    split = spill_split(make_state, batches_device, host_batches, work, "speech")
    route = route_cost(make_state, list(batches_device()))
    pinned = bool(spilled["ds"].recordings.is_pinned())
    bytes_per_step = BATCH * (C * L + int(ds.y_stream.shape[1]) * L) * 4
    del train_pool, test_pool, ds, device_ds, spilled

    out = os.path.join(work, "spill_out")
    tcfg = compose(CONFIGS_DIR, "config", [
        f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
        f"batch_size={BATCH}", "epochs=1", f"updates={TRAIN_UPDATES}",
        "fuse_gather=false", "run_name=spill"])
    expected = dict(unfused_launches, window_gather=0)
    cli = spill_cli(train_speech.run, tcfg, work, "speech", expected)
    emit({"phase": "spill_speech", **check, "pinned": pinned,
          "h2d_bytes_per_step": bytes_per_step,
          "onsets_between_clamps": between, "split": split,
          "quantile_route": route, **cli})
    return cli["launches"]


def phase_spill_god(cfg, god_ds, seed, work, god_launches) -> dict:
    """The GOD spill path: steps on the spilled train split's host batches
    through the prefetch against the device-resident steps on the same
    draws, then ``cli/train_god.py`` with ``host_resident``: the launches
    of the device-resident CLI (`god_training`).  Returns them."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg, roi(cfg))
    loss_cfg = train_god._loss_config(cfg)
    collate = evaluate_speech.collate_config(cfg)
    host = god_ds.to_host()
    rng = np.random.RandomState(seed + 9)
    draws = [rng.randint(0, len(god_ds), BATCH) for _ in range(SPILL_STEPS + 1)]

    def make_state():
        model = get_model(cfg, loc, device=dev, seed=seed, num_channels=len(loc))
        opt = make_optimizer(cfg, SPILL_STEPS + 1)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        return model, state, make_train_step(model, opt, loss_cfg, collate)

    def batches_device():
        return (god_ds.gather(i)[:3] for i in draws)

    def host_batches():
        return (host.gather(i)[:3] for i in draws)

    def batches_spill():
        return prefetch_to_device(host_batches(), size=2, device=dev)

    check = same_draw_runs(make_state, batches_device, batches_spill)
    split = spill_split(make_state, batches_device, host_batches, work, "god")
    route = route_cost(make_state, list(batches_device()))
    pinned = bool(host.X.is_pinned())
    del host
    tcfg = Config(dict(to_dict(cfg), save_root=os.path.join(work, "spill_god"),
                       run_name="spill"))
    cli = spill_cli(train_god.run, tcfg, work, "god", dict(god_launches))
    emit({"phase": "spill_god", **check, "pinned": pinned, "split": split,
          "quantile_route": route, **cli})
    return cli["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke run of the port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    resolve_device("cuda")  # TF32 off for f32 parity
    seconds, clock = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Wall seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    phase_build()
    phase_device()
    lap("build")

    work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
    try:
        t0 = time.perf_counter()
        cfg, ds, tr_idx = full_width_speech(
            work, args.seed, [f"save_root={os.path.join(work, 'out')}",
                              f"batch_size={BATCH}"])
        emit({"phase": "data", "seconds": time.perf_counter() - t0,
              "recordings": list(ds.recordings.shape),
              "y_stream": list(ds.y_stream.shape), "segments": len(ds)})
        lap("data")

        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        measured = phase_kernels(ds, flush)
        bn = phase_bn_kernels(flush)[str(torch.float32)]
        del flush
        lap("kernels")
        serving = phase_serving(cfg, ds, tr_idx, args.seed)
        lap("serving")
        training = phase_training(cfg, ds, tr_idx, args.seed, work)
        lap("training")
        unfused = phase_unfused_step(cfg, ds, tr_idx, args.seed, work)
        lap("unfused_step")
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        presets = phase_presets(cfg, ds, tr_idx, args.seed, work, flush)
        del flush
        lap("presets")
        scan_speech = phase_scan_speech(cfg, ds, tr_idx, args.seed, work)
        del ds
        lap("scan_speech")

        god_cfg, god_ds = phase_god_data(work, args.seed)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        god = phase_god_kernels(god_cfg, god_ds, flush)
        del flush
        god_training = phase_god_training(god_cfg, god_ds, args.seed)
        god_eval = phase_god_eval(god_cfg)
        scan_god = phase_scan_god(god_cfg, god_ds, args.seed)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        zoo = phase_model_zoo(god_cfg, god_ds, args.seed, flush)
        del flush
        lap("god")

        # the serving artifact, the export CLI, checkpoint import, host spill
        artifact_spill_paths = phase_serving_export(cfg, god_cfg, god_ds, args.seed, work)
        lap("serving_export")
        artifact_spill_paths.update(phase_export_cli(cfg, god_cfg, args.seed, work))
        lap("export_cli")
        artifact_spill_paths["torch_import"] = phase_torch_import(cfg, args.seed, work)
        lap("torch_import")
        artifact_spill_paths["spill_speech_cli"] = phase_spill_speech(cfg, args.seed, work,
                                                       unfused)
        lap("spill_speech")
        artifact_spill_paths["spill_god_cli"] = phase_spill_god(
            god_cfg, god_ds, args.seed, work, god_training["launches"])
        lap("spill_god")

        brennan_ds, row_len, brennan_build = phase_brennan_data(args.seed)
        lap("brennan_data")
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        brennan_k = phase_brennan_kernels(row_len, flush)
        del flush
        lap("brennan_kernels")
        brennan_train = phase_brennan_training(brennan_ds, args.seed)
        del brennan_ds
        lap("brennan_training")
        brennan_cli = phase_brennan_cli(work, args.seed)
        lap("brennan_cli")

        phase_w2v_features(args.seed)
        lap("w2v_features")
        phase_clip_features(args.seed)
        lap("clip_features")
        phase_gwilliams_preprocess(work, args.seed)
        lap("gwilliams_preprocess")
        brennan_embed = phase_brennan_embed_cli(work, args.seed)
        lap("brennan_embed_cli")
        god_error = phase_god_error_analysis(god_cfg, work, args.seed)
        lap("god_error_analysis")
        entry = phase_entry_points(god_cfg, work)
        lap("entry_points")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    new_paths = {**{f"preset_{k}": v for k, v in presets["launches"].items()},
                 "scan_speech": scan_speech, "scan_god": scan_god,
                 **{f"zoo_{k}": v for k, v in zoo["launches"].items()},
                 "unfused_cli": unfused}
    # the Brennan paths, each with the kernels it must launch
    brennan_paths = {
        **{f"brennan_build_{k}": (v, ("robust_quantiles_long",))
           for k, v in brennan_build.items()},
        "brennan_training": (brennan_train["launches"],
                             ("bn_stats", "bn_bwd_stats")),
        "brennan_train_cli": (brennan_cli["train"], ("robust_quantiles_long",
                                                     "bn_stats", "bn_bwd_stats")),
        "brennan_eval_cli": (brennan_cli["eval"], ("robust_quantiles_long",)),
        "brennan_embed_train_cli": (brennan_embed["train"], (
            "robust_quantiles_long", "bn_stats", "bn_bwd_stats")),
        "brennan_embed_eval_cli": (brennan_embed["eval"],
                                   ("robust_quantiles_long",))}
    # the GOD eval path with error analysis, and the dispatching entry points
    god_extra_paths = {
        **{f"god_error_analysis_{k}": v for k, v in god_error.items()},
        **{f"entry_{k}": v for k, v in entry.items()}}
    for path, launches in god_extra_paths.items():
        needed = (("window_gather", "robust_quantiles") if "evaluate" in path
                  or "error" in path else tuple(launches))
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    for path, (launches, needed) in brennan_paths.items():
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    for path, launches in artifact_spill_paths.items():
        needed = (("robust_quantiles", "bn_stats", "bn_bwd_stats")
                  if path.startswith("spill") else ("robust_quantiles",))
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    for path, launches in (("serving", serving), ("training", training["launches"]),
                           *new_paths.items()):
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    paths = {"serving": serving, "training": training["launches"],
             "god_training": god_training["launches"], "god_eval": god_eval,
             **new_paths, **{k: v for k, (v, _) in brennan_paths.items()},
             **god_extra_paths, **artifact_spill_paths}
    for name in training["launches"]:
        if paths["god_training"][name] + paths["god_eval"][name] <= 0:
            raise AssertionError(f"{name}: no launch on the GOD paths")
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in (*training["launches"], "robust_quantiles_long")}
    by_path = lambda k: {p: n.get(k, 0) for p, n in paths.items()}
    g = measured["gather"][:2]  # one batch: the X and the f32 Y gather
    q = measured["quantiles"]
    # the kernels' device time in one f32 training step (bn_bwd: the whole
    # BN backward), against its time
    per_step = (sum(c["kernel_ms"] for c in g) + q["kernel_ms"]
                + BN_PER_STEP * (bn["bn_stats"]["kernel_ms"]
                                 + bn["bn_bwd_stats"]["kernel_ms"]))
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    emit({"phase": "step_share", "kernels_ms_per_step": per_step,
          "steady_step_ms": training["steady_step_ms"],
          "share": per_step / training["steady_step_ms"]})
    gq, gbn = god["quantiles"], god["bn"][str(torch.float32)]
    god_per_step = gq["kernel_ms"] + BN_PER_STEP * (
        gbn["bn_stats"]["kernel_ms"] + gbn["bn_bwd_stats"]["kernel_ms"])
    emit({"phase": "god_step_share", "kernels_ms_per_step": god_per_step,
          "steady_step_ms": god_training["steady_step_ms"],
          "share": god_per_step / god_training["steady_step_ms"]})
    at_god = lambda r: {k: r[k] for k in ("max_abs_err", "kernel_ms", "run_ms",
                                          "plain_ms", "library_ms")}
    god_rows = {
        "window_gather": dict(at_god(god["gather"]), shape=god["gather"]["shape"],
                              bound_ms=god["gather"]["bound_us"] / 1e3),
        "robust_quantiles": dict(at_god(gq), shape=gq["shape"],
                                 bound_ms=gq["bound_us"] / 1e3),
        **{name: {dt: dict(at_god(rows[name]), shape=[BATCH, D2, int(god_ds.X.shape[2])],
                           bound_ms=rows[name]["bound_ms"])
                  for dt, rows in god["bn"].items()}
           for name in ("bn_stats", "bn_bwd_stats")}}
    def at(r, shape):
        return {"shape": shape, "ms": r["kernel_ms"], "run_ms": r["run_ms"],
                "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                "bound_ms": r["bound_ms"] if "bound_ms" in r else r["bound_us"] / 1e3}
    cg, cq = presets["chunk_gather"], presets["chunk_quantiles"]
    bl = brennan_k["subject-wise"]
    more = {
        "window_gather": {"sweep chunk": at(cg, cg["shape"]),
                          **{f"B=256 {k}": at(c, c["shape"])
                             for k, c in presets["b256_gather"].items()}},
        "robust_quantiles": {"sweep chunk": at(cq, cq["shape"])},
        **{name: {"B=256 bf16": at(presets["b256_bn"][name], [4 * BATCH, D2, 360]),
                  **{shape: at(rows[name], shape) for shape, rows in zoo["bn"].items()}}
           for name in ("bn_stats", "bn_bwd_stats")}}
    emit({"kernels": [
        {"name": "window_gather", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/window_gather.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/window_gather.py:126",
         "launches": launches["window_gather"],
         "launches_by_path": by_path("window_gather"),
         "max_abs_err": max(c["max_abs_err"] for c in g),
         "ms": sum(c["kernel_ms"] for c in g),
         "run_ms": sum(c["run_ms"] for c in g),
         "plain_ms": sum(c["plain_ms"] for c in g),
         "bound_ms": sum(c["bound_us"] for c in g) / 1e3, "bound_by": "bytes",
         "library_ms": sum(c["library_ms"] for c in g),
         "god": god_rows["window_gather"], "more_shapes": more["window_gather"]},
        {"name": "robust_quantiles", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/robust_quantiles.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/quantile.py:120",
         "launches": launches["robust_quantiles"],
         "launches_by_path": by_path("robust_quantiles"),
         "max_abs_err": q["max_abs_err"], "ms": q["kernel_ms"],
         "run_ms": q["run_ms"], "plain_ms": q["plain_ms"],
         "bound_ms": q["bound_us"] / 1e3,
         "bound_by": "bytes", "library_ms": q["library_ms"],
         "god": god_rows["robust_quantiles"],
         "more_shapes": more["robust_quantiles"]},
        # the global-memory path of the same source, for rows past the
        # shared-memory limit, at Brennan's subject-wise rows
        {"name": "robust_quantiles_long", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/robust_quantiles.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/quantile.py:120",
         "launches": launches["robust_quantiles_long"],
         "launches_by_path": by_path("robust_quantiles_long"),
         "max_abs_err": max(r["max_abs_err"] for r in brennan_k.values()),
         "max_ulp": max(r["max_ulp"] for r in brennan_k.values()),
         "shape": bl["shape"], "ms": bl["kernel_ms"], "run_ms": bl["run_ms"],
         "plain_ms": bl["plain_ms"], "bound_ms": bl["bound_ms"],
         "bound_by": "bytes", "library_ms": bl["library_ms"],
         "library_refused": bl["library_refused"],
         "more_shapes": {k: dict(at(r, r["shape"]),
                                 library_refused=r["library_refused"])
                         for k, r in brennan_k.items() if k != "subject-wise"}},
        *({"name": name, "route": "cuda",
           "source": "meg_decoding_tpu_torch/csrc/batchnorm_stats.cu",
           "replaces": f"meg_decoding_tpu/ops/pallas/batchnorm.py:{line}",
           "launches": launches[name], "launches_by_path": by_path(name),
           "max_abs_err": bn[name]["max_abs_err"], "ms": bn[name]["kernel_ms"],
           "run_ms": bn[name]["run_ms"],
           "plain_ms": bn[name]["plain_ms"], "bound_ms": bn[name]["bound_ms"],
           "bound_by": bn[name]["bound_by"],
           "library_ms": bn[name]["library_ms"],
           "god": god_rows[name], "more_shapes": more[name],
           **{k: bn[name][k] for k in extra}}
          for name, line, extra in (
              ("bn_stats", 69, ("library_batch_norm_stats_ms",)),
              # bn_bwd (sums and dx) above; its sums alone beside them
              ("bn_bwd_stats", 111, ("stats_only_ms", "stats_only_run_ms",
                                     "stats_only_library_ms")))),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
