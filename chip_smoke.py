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

It checks the port on the card, times each kernel alone, and times the
paths that no cell of ``BENCHMARK.json`` measures yet.  A phase that runs
only routes a cell measures (the fused f32 B = 64 speech step, the GOD
per-step step, the bf16 B = 256 presets' steps) checks them and leaves
their times to ``benchmark/run.py``.  The eager routes, which no CLI or
server takes on the card, are checked against the graphs and not timed.
Phases, each printed as one JSON line:

1. build    — compile the four CUDA sources of
              ``meg_decoding_tpu_torch/csrc`` (window_gather,
              robust_quantiles, batchnorm_stats, gelu_erf_poly; one nvcc
              per source, in parallel);
2. device   — the card's name and power limit, as nvidia-smi reports them;
    bench    — (after ``brennan_kernels``) ``bench_torch.py --scale small
              --steps 5 --windows 2 --big-batches ''`` in a fresh process:
              the port's benchmark (``cli/bench.py``) at the full model
              width on 2 subjects × 2 sessions × 120 s, every row of it
              (f32 and bf16 B = 64, the whole epoch, the cached statistics,
              an eval pool, the sentence split, the promoted recipe, B =
              256), none skipped, every MFU in (0, 1.05], and each kernel
              launched, as its ``# bench-launches:`` line counts them;
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
              the L2 (``run_ms``), and the host's time a call of the
              kernel's wrapper and of the library call (``host_us``).  The
              Pallas ``bn_bwd_stats`` row is the train path's kernel,
              ``bn_bwd`` (sums and dx in one launch); its sums alone
              (``bn_bwd_stats``) are timed beside it.  ``bn_stats`` names
              its route (per_channel, cluster) in each row, and runs
              each route on a grid of shapes (``bn_stats_routes``);
    bn_time_major — (after ``kernels``) the BN kernels' time-major route
              (bf16 activations (B, T, C)) against the plain versions at
              the bf16 presets' (256, 360, 320) and the f32 step's
              (64, 360, 320) and at shapes off them, each result
              bit-identical across two launches and across replays of a
              captured graph, timed against the byte bound and beside the
              NCW kernels on the same values; ``--phase bn_time_major``
              adds a captured full-width ``configs/throughput.yaml`` step:
              10 time-major launches of each kernel a replay and no NCW
              launch, by the launch counters;
    gelu     — (after ``kernels``) the erf_poly GELU's forward and
              backward kernels against the plain op chain: bf16 at the
              exact-GELU step's three shapes ((256, 320, 360),
              (256, 640, 360), (256, 1024, 360)) and f32 at (64, 320, 360),
              timed like phase 3 against their byte bound, the chain and
              ``F.gelu`` (exact erf) and its backward, then a numel no
              16-byte packet divides, Seq2Static's (64, 512, 1), a base off
              16-byte alignment (each within 1 bf16 ulp, or f32 rtol 2e-6 /
              atol 1e-6, NaNs where the chain has them) and a
              non-contiguous input (refused); ``--phase gelu`` adds a
              captured ``configs/throughput_exact.yaml`` step at full
              width, whose replays must launch each kernel 12 times;
    adam     — (after ``kernels``) Adam's multi-tensor kernel on the speech
              and GOD encoders' parameter lists (9.57 M and 7.34 M
              elements): p, mu and nu bit for bit against the eager chain
              over 8 steps (one skipped, one None gradient), then timed
              like phase 3 against its byte bound (28 bytes an element),
              the chain and torch.optim.Adam's ``_foreach_*`` route;
              ``--phase adam`` adds the captured full-width bf16, f32 and
              GOD steps, whose replays must launch it once each and the
              chain never (the train CLIs' phases check the same);
4. serving  — a synthetic 27-subject cache, 4 requests of 64 raw windows
              through ``serving/forward.py`` (Z checked finite, of shape
              (64, 1024, 360), and against the same model on the CPU), then
              the eval CLI over the test pools; the requests replay one
              captured graph of the forward, the eval CLI its own forward's
              one graph a pool;
5. training — one train step on the card against the same step on the CPU
              (loss and global gradient norm within 1e-4), a few fused
              steps' losses, then the train CLI
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
              global gradient norm within 1e-4), a few per-step losses,
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
              steps' losses, then the train CLI for one epoch of 4 updates with
              each preset (exact launch counts; the erf_poly GELU's
              kernels 12 times a step each way and 12 times a test pool
              forward, never under tanh GELU);
    scan_epochs — in the speech and in the GOD part: one epoch of 4
              updates of the whole-epoch form against the per-step path on
              the same draws, in turns, cuDNN deterministic (mean loss and
              every state entry within 1e-5 relative; the times of the two
              epoch runs printed), then the
              train CLI with ``use_scan_epochs`` (speech on the sentence
              split), exact launch counts;
    graphs — (speech paths after ``training``, GOD paths after
              ``god_training``) the train step as one captured CUDA graph
              (``train/graph.py``) against the eager step, from one init
              on the same draws, cuDNN deterministic: (a) the fused speech
              step at ``config.yaml``'s width, f32, B = 64, 6 steps; (b)
              the same under ``throughput.yaml`` as published (bf16,
              B = 256, cached statistics); (c)
              ``make_gwilliams_scan_epoch`` and (d) ``make_scan_epoch`` on
              ``config_GOD.yaml``'s brain encoder, 2 epochs of 4 updates;
              (e) GOD's ``fit`` step with ``model=eegnet`` (its dropout
              masks drawn on the host), 6 steps.  Each path: state and
              metrics within 1e-5 of each tensor's max (and whether bit-
              identical), each kernel's launches a replay equal to the
              eager step's, one replay a step and one capture, the graph's
              ms a step (median), capture seconds, peak memory, then the
              graph route under torch.profiler with cuDNN's default
              algorithms (captured again): ms, device operations and busy
              ms a step, idle share.  Every train CLI
              (``training``, ``unfused_step``, ``presets``,
              ``scan_epochs``, ``god_training``, ``model_zoo``,
              ``brennan_cli``, the spill and data-parallel CLIs) must
              replay its graph once a step, after one capture;
    serve_graphs — (speech after ``graphs``, GOD after ``model_zoo``) the
              forward-only programs as captured CUDA graphs: the serving
              forward (``serving/export.py:make_serving_forward``) and the
              exported artifact (``ServingModel``, one graph a batch size)
              of ``config.yaml``'s seq2seq encoder and ``config_GOD.yaml``'s
              brain encoder at B = 1, 8 and 64, and the eval step
              (``train/steps.py:EvalStep``) on one test pool of 64 of each.
              Each path: the graph's capturing call and a replay bit-
              identical to the eager body under cuDNN's deterministic
              algorithms, each with the eager call's launches, two forward
              replays after one capture, card vs CPU within 1e-4·max|Z|;
              then, with the default algorithms and a new graph, the graph
              route's request ms (first, p50, p90), device operations and
              busy ms a request and idle share (torch.profiler), peak
              memory and capture seconds.  Then
              GOD's ``fit`` (2 epochs of 2 updates, 2 test pools) with its
              train and eval graphs against ``fit`` with both routes eager
              (``EagerStep``), cuDNN deterministic: end state and every
              epoch's metrics bit-identical, launches equal, the replays
              of each route.  Every single-card train CLI's test pools
              replay one eval graph (one capture, one replay a pool),
              also on the spill route; the DP route scores them eagerly;
              the eval CLIs replay one graph of the forward;
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
              its plain version (0 ulp, equal NaN positions, hard rows
              included) at 64 × 58,113, the subject-wise 1,980 × 88,920
              and the pooled 60 × 2,934,360 rows, and at the subject-wise
              shape on a quantized and a constant input, timed against one
              read of the rows, with its device time by launch
              (``pass_ms``, torch.profiler), its launches a call and the
              candidate bytes it writes a call (this phase runs first,
              right after the build, at the build's row length);
    brennan_training — the unfused step at the full width on the built
              dataset: its first step against the CPU (loss and global
              gradient norm within 1e-4), then the step replayed as a CUDA
              graph under ``torch.profiler`` (``graph``: ms, operations,
              busy, idle share, capture s, peak memory);
    brennan_cli — the train CLI for one epoch of 4 updates on
              ``make_synthetic_brennan_raw``'s files (6 subjects × 60
              channels × 120 s, subjects pooled: rows of 84,240 keys), then
              the eval CLI on its checkpoint; exact launch counts, the
              train CLI one graph replay an update, each CLI's peak memory;
    w2v_features — wav2vec2-large-xlsr-53 (317 M parameters) with seeded
              random weights: every hidden state of a 3 s clip card against
              CPU (max|Δ| ≤ 1e-4·max|ref|), a 2-layer copy's chunked,
              masked last-4 average over 45 s card against CPU (same
              bound), the full model's over 45 s through its chunk graph
              bit-identical to the same chunks run eagerly (cuDNN
              deterministic), then the full model over 742 s of 16 kHz
              audio (the last-4 average (1024, T′), one chunk-graph replay
              a chunk, and the conv features (512, T′): seconds, frames/s,
              peak memory);
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
              else), a weight scaled by 1.5 changing Z and setting it back
              giving the first Z bit for bit, and the serving benchmark's
              rows (``cli/serving_benchmark.py:latency_row``, graph and
              artifact at B = 1, 8, 64);
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
              against the device-resident unfused steps on the same draws,
              each stepped eagerly and replayed as one graph (cuDNN
              deterministic; each graph route bit-identical to its eager
              route, spilled against device-resident within 1e-5), the
              graph routes' step time and capture s, each route's peak
              memory, each graph route run again under torch.profiler for
              its split (the compute thread's time in and out of
              operators, the card's busy time, operations and idle share,
              the spill producer's time a batch), the registered
              percentile op against a direct call of the launch (a call's
              host time), the onsets between the two gathers' clamps,
              then the train CLI with ``host_resident`` and its epoch traced
              (``profile_dir``): the unfused CLI's launches without its
              gathers, one train replay an update, the port's kernels in
              the replays and a host-to-device copy on a stream other than
              the replays' in the trace;
    spill_god — the same for the GOD trainer: the spilled train split's
              host batches against the device-resident ones, the split and
              the route's cost, then
              ``cli/train_god.py`` with ``host_resident`` (the device CLI's
              launches) and its trace;
    data_parallel — in the speech and in the GOD part, on a one-rank
              NCCL group through ``setup_data_parallel``: 6 fused speech
              steps (session-sharded gather, collate, synced BN by the
              split route, sharded CLIP loss, one flat gradient
              all-reduce) and 6 GOD per-step steps against the
              single-device steps on the same draws, cuDNN deterministic
              (the first step's loss and gradient norm within 1e-5, later
              steps' within 1e-4, the first step's gradients within 1e-4
              of each tensor's max, every state entry within rtol 1e-4 /
              atol 1e-5 but those whose gradient is at rounding level —
              by name, or by the runs' difference in it — within 2·n·lr:
              Adam moves such an entry up to lr a step; the count of
              those entries is printed), exact launches
              (``bn_bwd_stats``'s sums alone and ``bn_bwd_dx`` once per BN
              layer a step), the DP step's graph route against its eager
              route bit for bit (the graph route's times, operations, idle
              share, capture s, peak memory; the collectives the capture
              records against those the eager step issues, none from the
              host in a replay, and the NCCL kernels' device time a
              replay), the loose entries by tensor
              (count, share, |g| beside the tensor's, |Δg|/|g|), the split
              BN backward's dx bit-identical to the fused ``bn_bwd``'s and
              ``bn_bwd_dx`` against its plain version (timed, with its host
              time beside the library's, at (64, 320, 360) and (64, 320,
              24), f32 and bf16); then the speech train CLI for one epoch
              with a ``distributed:`` block of one process, per step and
              with ``use_scan_epochs`` (one train replay an update, one
              eval replay a pool); the NCCL version;
    kamitani — the Kamitani baseline on the GOD set: the CLI's ``run``
              (SCP time-mean, 512 units, 22 channels, 200 iterations),
              then ``feature_prediction`` card against CPU (rates equal,
              predictions within 1e-4·max, a mask bit may differ only
              where its weight is within 1e-4 of the unit's max), both
              timed;
    galleries — 1,250 PNG files of mixed GOD-like sizes (50 written
              with ``utils/png.py``, the rest hard links to them), the
              gallery CLI on the card with random-weight ViT-B/32
              (images/s; a file's decoding and resize timed apart), 8 of
              them card against CPU;
    spill_brennan — (after brennan_training) the subject-wise Brennan set
              spilled through ``BrennanPacked.to_host``: unfused steps on
              its host batches through ``prefetch_to_device`` against the
              device-resident steps on the same chunk and subject draws,
              eager and graph (as spill_speech), the ms a step of each
              graph route, exact launches;
    import_cli — (these five after entry_points) a random
              ``configs/config.yaml`` encoder written as a reference
              ``.pt`` and imported by ``cli/import_torch_checkpoint.py``
              (every entry bit-identical to the source model), then the
              speech eval CLI on the speech cache, the export CLI, and one
              artifact request at B = 64 against the source model's
              served forward (≤ 1e-5 · max|ref|); import, eval and export
              seconds;
    attention_maps — ``examples/attention_check.py`` on that checkpoint:
              270 maps over 208 sensors against a float64 NumPy softmax
              (≤ 1e-5 · max), the PNG's bytes;
    inference_dump — a random ``config_GOD.yaml`` encoder imported, then
              ``examples/inference.py`` on the GOD set: Z of both splits
              bit-identical to ``predict`` of the source model;
    kamitani_sweeps — the four sweeps of
              ``examples/kamitani_regression.py`` at 200 iterations, each
              cut to 2 points over the occipital region: accuracies and
              seconds;
    quickstart — ``examples/quickstart_synthetic.py`` (Gwilliams, the
              script's widths and epochs, with export and the artifact
              call): seconds, launches;
11. ``seconds`` (each phase group's wall time; ``drivers``: the six phases
              above together), the ``kernels`` line (each
              kernel's launches by path, its times at the GOD shapes under
              ``god`` and at this slice's shapes under ``more_shapes``; the
              long-row path as ``robust_quantiles_long``), then the ``ok``
              line.

The serving, training, unfused, GOD training, GOD eval, preset, scan,
model-zoo, Brennan, error-analysis, entry-point, artifact, export, import,
spill and driver paths each run with
every launch count set to 0 just before and read just after; the run fails
unless each kernel launched on the speech paths and on the GOD paths, every
kernel on each preset, scan, model-zoo, unfused and training entry-point
path, ``bn_stats``' per_channel route on the speech and GOD training
paths, its cluster route on EEGNet's and per_channel on
Seq2Static's, the long-row path on each Brennan build and CLI (with and without
the embedding), the BN kernels in Brennan training, the gather and the
percentiles on each GOD evaluation, the percentiles on each artifact,
export and import path, and the percentiles and BN kernels on both spill
CLIs, the BN kernels in the Brennan spill steps, the gather and the
percentiles in the imported checkpoint's eval and in the feature dump, the
percentiles in its artifact request, the gather in the Kamitani sweeps, and
every kernel in the quickstart.  The encoders and the preprocessing
run no TPU kernel in the JAX package, and none here.

Any failure raises and exits non-zero.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``;
``--phase graphs`` (or ``serve_graphs``) runs the build, the speech cache,
that phase's speech paths, the GOD data and its GOD paths, and stops;
``--phase bench`` runs the build and the ``bench`` phase; ``--phase gelu``
the build, the ``gelu`` phase and a captured exact-GELU step; ``--phase
w2v`` the build and the ``w2v_features`` phase; ``--phase bn_time_major``
the build, that phase and its captured throughput step; ``--phase moe``
the build and the MoE kernels' phase; ``--phase adam`` the build, the
``adam`` phase and the captured bf16, f32 and GOD steps; ``--phase kimi``
the build and Kimi-Linear's kernels' phase (its KDA, convolution and
sigmoid route kernels, then a small model's chunk graphs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as tnf

from meg_decoding_tpu_torch.cli import (
    evaluate_god,
    evaluate_speech,
    train_god,
    train_speech,
)
from meg_decoding_tpu_torch.cli.profile_train_step import profile_config
from meg_decoding_tpu_torch.cli.serving_benchmark import (
    latency_row,
    request_profile,
)
from meg_decoding_tpu_torch.core.config import Config, compose, to_dict
from meg_decoding_tpu_torch.data.brennan import build_brennan_dataset
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.data.prefetch import prefetch_to_device, to_device
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
from meg_decoding_tpu_torch.parallel.dp import (
    finish_distributed,
    maybe_distributed_init,
    setup_data_parallel,
)
from meg_decoding_tpu_torch.ops.batchnorm import batch_norm_train
from meg_decoding_tpu_torch.ops.kernels import adam as ak
from meg_decoding_tpu_torch.ops.kernels import batchnorm as bk
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import gelu as gk
from meg_decoding_tpu_torch.ops.kernels import kda as kk
from meg_decoding_tpu_torch.ops.kernels import moe as mk
from meg_decoding_tpu_torch.ops.kernels import quantile as qk
from meg_decoding_tpu_torch.ops.kernels import launch_counts, reset_launches
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
    ServingModel,
    load_artifact,
    make_serving_forward,
    save_artifact,
)
from meg_decoding_tpu_torch.train import graph as tg
from meg_decoding_tpu_torch.train import loop
from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
from meg_decoding_tpu_torch.train.graph import GraphedStep
from meg_decoding_tpu_torch.train.loop import _test_pool_starts
from meg_decoding_tpu_torch.train.optim import Adam
from meg_decoding_tpu_torch.train.scan_loop import (
    epoch_means,
    make_fused_speech_step,
    make_gwilliams_scan_epoch,
    make_scan_epoch,
)
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import make_eval_step, make_train_step
from meg_decoding_tpu_torch.utils.logging import RunLogger

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_FLOP_PER_S = 67e12     # H100 SXM published f32 rate outside the tensor cores
L2_BYTES = 50 * 2**20      # H100 L2 cache
C, F = FULL_WIDTH_CACHE["C"], FULL_WIDTH_CACHE["F"]
BATCH, N_REQUESTS = 64, 4
D2 = 320                   # BN width of every ConvBlock in configs/config.yaml
TRAIN_UPDATES, FUSED_STEPS = 6, 10
BN_PER_STEP = 10           # 5 ConvBlocks × (bn0, bn1)
PRESETS = ("throughput", "throughput_exact")  # configs/*.yaml, as published
PRESET_UPDATES, PRESET_STEPS = 4, 6
SCAN_UPDATES = 4
EEGNET_BN = 3              # bn1, bn2, bn3
# the speech step's GELU sites by shape at B = 256 (configs/
# throughput_exact.yaml): 2 in each of 5 ConvBlocks, the two final ones
GELU_SITES = {(256, 320, 360): 10, (256, 640, 360): 1, (256, 1024, 360): 1}
GELU_PER_STEP = sum(GELU_SITES.values())
# DeepSeek-V2-Lite's MoE a chunk: tokens, routed experts, top-k, hidden
MOE_CHUNK = (2048, 64, 6, 2048)
# Kimi-Linear-48B-A3B's a chunk: tokens, KDA heads, routed experts, top-k,
# hidden, experts held; its KDA and MoE layers
KIMI_CHUNK = (2048, 32, 256, 8, 2304, 128)
KIMI_KDA_LAYERS, KIMI_MOE_LAYERS = 20, 26
# the encoders whose parameter lists Adam updates: (sensors, subjects, F,
# seq2seq) of the benchmark's gwilliams_speech and god_image
ADAM_LISTS = {"speech": (208, 27, 1024, True), "god": (22, 1, 512, False)}
ADAM_STEPS = 8
GELU_STEPS = 3
# the run_ms in µs that PERF.md §6 records for the kernels these replaced
# (one CTA per channel for bn_stats, the first bn_bwd_dx; NVIDIA H100 80GB
# HBM3, 700 W), printed beside this run's
PARENT_RUN_US = {
    ("bn_stats", (64, 320, 360), "torch.float32"): "13.1-13.5",
    ("bn_stats", (64, 320, 24), "torch.float32"): "3.9-4.0",
    ("bn_stats", (64, 16, 528), "torch.float32"): "7.3-7.5",
    ("bn_stats", (256, 320, 360), "torch.bfloat16"): "23.5-24.3",
    ("bn_bwd_dx", (64, 320, 360), "torch.float32"): "33.9-34.5",
    ("bn_bwd_dx", (64, 320, 360), "torch.bfloat16"): "17.4-17.6",
    ("bn_bwd_dx", (64, 320, 24), "torch.float32"): "4.6-4.7",
    ("bn_bwd_dx", (64, 320, 24), "torch.bfloat16"): "3.8-4.0",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, the L2 cache
    flushed (a 256 MB memset) before each so every run reads cold.  A time
    of one launch: it includes the launch and the events themselves."""
    return time_ms_turns([fn], flush, reps)[0]


def time_ms_turns(fns, flush: torch.Tensor, reps: int = 30) -> list:
    """``time_ms`` of each of ``fns``, their runs taken in turns (a, b, a,
    b, …) so that each sees the card and the host in the same state."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


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


def host_us(fn, n: int = 1000, batch: int = 100) -> float:
    """Host time per call of ``fn`` in µs: the host clock over ``n``
    back-to-back calls with no synchronise among them, divided by ``n``.
    The calls go in batches of ``batch``, each queued behind a sleep kernel
    longer than the batch takes to queue, so that the device never holds
    the host back (the synchronise between batches is not timed)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // batch):
        torch.cuda._sleep(4 * 10**7)  # >= 20 ms at <= 2 GHz
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (n // batch * batch) * 1e6


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


def phase_device() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return line


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
    var cotangents when ``cotangents``, and ``bn_bwd_dx`` from bn_bwd's
    sums equal to its dx bit for bit."""
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
    # bn_bwd_dx from the fused kernel's own sums: its dx bit for bit
    split = bk.bn_bwd_dx(g, x, scale, mean, invstd, torch.stack([sg, sgx]), M,
                         *cots)
    if not torch.equal(split.view(bits), dx.view(bits)):
        raise AssertionError(f"bn_bwd_dx {shape} {x.dtype}: not the fused "
                             "bn_bwd's dx")
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
    var_mean = lambda: torch.var_mean(x, dim=(0, 2), correction=0)
    route = bk._bn_stats_route(x)[2]
    rows = {
        "bn_stats": {
            "stats_route": route,
            "max_abs_err": max(err["sum_x"], err["sum_x2"]),
            "kernel_ms": time_ms(lambda: bk.bn_stats(x), flush),
            "run_ms": run_ms([lambda x=x: bk.bn_stats(x) for x in xs]),
            "host_us": host_us(lambda: bk.bn_stats(x)),
            "plain_ms": time_ms(lambda: bk.bn_stats_plain(x), flush),
            "library_ms": time_ms(var_mean, flush),
            "library_host_us": host_us(var_mean),
            "parent_run_us": PARENT_RUN_US.get(("bn_stats", tuple(x.shape), str(dtype))),
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


STATS_GRID_C = (1, 7, 16, 21, 32, 131, 133, 263, 264, D2)
STATS_GRID_T = (24, 37, 528)


def bn_stats_routes() -> dict:
    """``bn_stats`` on each of its routes at every shape of a grid: B = 64,
    C of STATS_GRID_C (the route rule's bounds at 132 and 264 channels on
    an H100 among them), T of STATS_GRID_T (short, unaligned and long
    rows), f32 and bf16, then bases one element past a 16-byte boundary
    and the speech step's (64, 320, 360).  Every route forced in turn: two
    launches bit-identical, each sum within 1e-5 of Σ|term| of the plain
    version; the launcher's own pick bit-identical to its route forced;
    at the speech step's shape the pick is per_channel, the parent's
    kernel and launch unchanged.  Returns the pick by shape and the
    largest error of each route."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(Cc, T, dt, 0) for Cc in STATS_GRID_C for T in STATS_GRID_T
             for dt in dtypes]
    cases += [(Cc, T, dt, 1) for Cc in (16, D2) for T in (24, 528)
              for dt in dtypes]
    cases += [(D2, 360, dt, 0) for dt in dtypes]
    ncw_routes = tuple(r for r in bk.STATS_ROUTES if r != "time_major")
    picks, worst = {}, dict.fromkeys(ncw_routes, 0.0)
    for Cc, T, dtype, offset in cases:
        x, _ = bn_inputs(gen, BATCH, Cc, T, dtype, offset)
        what = f"{BATCH}x{Cc}x{T} {dtype}" + (" base+1" if offset else "")
        xf = x.float()
        want = bk.bn_stats_plain(x)
        tol = (1e-5 * xf.abs().sum((0, 2)), 1e-5 * (xf * xf).sum((0, 2)))
        got = {}
        for route in ncw_routes:
            a, b = bk._bn_stats_route(x, route), bk._bn_stats_route(x, route)
            torch.cuda.synchronize()
            for k in range(2):
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"bn_stats {route} {what}: two "
                                         "launches differ")
                d = (a[k] - want[k]).abs()
                if not bool((d <= tol[k]).all()):
                    raise AssertionError(f"bn_stats {route} {what}: off by "
                                         f"{float((d / tol[k]).max())} of "
                                         "its bound")
                worst[route] = max(worst[route], float(d.max()))
            got[route] = a
        pick = bk._bn_stats_route(x)[2]
        auto = bk.bn_stats(x)
        if not all(torch.equal(auto[k], got[pick][k]) for k in range(2)):
            raise AssertionError(f"bn_stats {what}: the launcher's pick "
                                 f"{pick} differs from that route forced")
        picks[what] = pick
    for dtype in dtypes:
        if picks[f"{BATCH}x{D2}x360 {dtype}"] != "per_channel":
            raise AssertionError("bn_stats: the speech step's shape left the "
                                 "per_channel route")
    return {"picks": picks, "max_abs_err": worst,
            "tolerance": "1e-5 of sum |term| per channel; bit-identical "
                         "across two launches and to the route forced"}


def phase_bn_kernels(flush) -> dict:
    """The BN kernels at the speech training step's shape (64, 320, 360) in
    f32 and bf16, timed (``bn_rows``), ``bn_stats`` on each route across a
    grid of shapes (``bn_stats_routes``), and the BN kernels at shapes off
    the main paths."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {str(dtype): bn_rows(*bn_inputs(gen, BATCH, D2, 360, dtype), flush,
                               "kernels")
           for dtype in (torch.float32, torch.bfloat16)}
    out["routes"] = bn_stats_routes()
    emit({"phase": "kernels", "kernel": "bn_stats", "routes": out["routes"]})
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


# the time-major BN route's shapes (B, T, C): the bf16 presets' and the f32
# speech step's, then off the main paths: C not a multiple of a 16-byte
# load, one channel, a group wider than 128 channels, fewer rows than one
# pass of a CTA, B = 65, T = 37, and bases one element past 16 bytes
TM_MAIN = (((4 * BATCH, 360, D2), torch.bfloat16),
           ((BATCH, 360, D2), torch.float32))
TM_OFF = (((BATCH, 360, 21), torch.bfloat16, 0, False),
          ((3, 37, D2), torch.float32, 0, True),
          ((3, 37, D2), torch.bfloat16, 0, True),
          ((BATCH, 360, 1), torch.float32, 0, False),
          ((2, 5, 1024), torch.bfloat16, 0, False),
          ((1, 3, 7), torch.float32, 0, True),
          ((BATCH + 1, 360, 24), torch.bfloat16, 0, False),
          ((BATCH, 24, D2), torch.float32, 1, True),
          ((BATCH, 24, D2), torch.bfloat16, 1, False),
          ((4 * BATCH, 48, D2), torch.bfloat16, 0, True))
TM_STEPS = 3  # replays of the throughput step counted


def bn_tm_check(x: torch.Tensor, g: torch.Tensor, cotangents: bool = False) -> dict:
    """The time-major BN kernels on (x, g) (B, T, C) against their plain
    versions as ``bn_check`` holds the NCW ones: each launched twice and
    the two bit-identical; the sums within 1e-5 of Σ|term| per channel;
    bn_bwd's dx within ``bn_bwd_check``'s bound (on the NCW views of the
    same tensors); ``bn_bwd_dx`` from bn_bwd's sums its dx bit for bit;
    the routes counted.  Returns the largest absolute errors."""
    what = f"time-major {tuple(x.shape)} {x.dtype}"
    C = x.shape[2]
    M = x.numel() // C
    before = (bk.stats_route_launches["time_major"],
              bk.bwd_route_launches["time_major"])
    s, ss = bk.bn_stats(x, time_major=True)
    mean = s / M
    invstd = torch.rsqrt(ss / M - mean * mean + 1e-5)
    gen = torch.Generator(device="cuda").manual_seed(C)
    scale = torch.rand(C, device="cuda", generator=gen) + 0.5
    cots = ((torch.randn(C, device="cuda", generator=gen),
             torch.randn(C, device="cuda", generator=gen))
            if cotangents else (None, None))
    got = {"sum_x": s, "sum_x2": ss}
    got["sum_g"], got["sum_gxhat"] = bk.bn_bwd_stats(g, x, mean, invstd, True)
    again = dict(zip(("sum_x", "sum_x2"), bk.bn_stats(x, True)))
    again.update(zip(("sum_g", "sum_gxhat"),
                     bk.bn_bwd_stats(g, x, mean, invstd, True)))
    bwd = [bk.bn_bwd(g, x, scale, mean, invstd, *cots, time_major=True)
           for _ in range(2)]
    want = dict(zip(("sum_x", "sum_x2"), bk.bn_stats_plain(x, True)))
    want.update(zip(("sum_g", "sum_gxhat"),
                    bk.bn_bwd_stats_plain(g, x, mean, invstd, True)))
    xf, gf = x.float(), g.float()
    xhat = (xf - mean) * invstd
    scale_ = {"sum_x": xf.abs().sum((0, 1)), "sum_x2": (xf * xf).sum((0, 1)),
              "sum_g": gf.abs().sum((0, 1)),
              "sum_gxhat": (gf * xhat).abs().sum((0, 1))}
    torch.cuda.synchronize()
    err = {}
    for k in got:
        if not torch.equal(got[k], again[k]):
            raise AssertionError(f"{what}: {k} differs between two launches")
        d = (got[k] - want[k]).abs()
        if not bool((d <= 1e-5 * scale_[k]).all()):
            raise AssertionError(f"{what}: {k} off by "
                                 f"{float((d / scale_[k]).max())} of Σ|term|")
        err[k] = float(d.max())
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    (dx, sg, sgx), (dx2, sg2, sgx2) = bwd
    if not (torch.equal(dx.view(bits), dx2.view(bits)) and torch.equal(sg, sg2)
            and torch.equal(sgx, sgx2)):
        raise AssertionError(f"bn_bwd {what}: two launches differ")
    split = bk.bn_bwd_dx(g, x, scale, mean, invstd, torch.stack([sg, sgx]), M,
                         *cots, time_major=True)
    if not torch.equal(split.view(bits), dx.view(bits)):
        raise AssertionError(f"bn_bwd_dx {what}: not the fused bn_bwd's dx")
    pdx, psg, psgx = bk.bn_bwd_plain(g, x, scale, mean, invstd, *cots,
                                     time_major=True)
    ncw = lambda t: t.transpose(1, 2)  # noqa: E731
    for k, v in bn_bwd_check(ncw(g), ncw(x), scale, mean, invstd,
                             (ncw(dx), sg, sgx), (ncw(pdx), psg, psgx),
                             f"bn_bwd {what}").items():
        err[f"bn_bwd_{k}"] = v
    after = (bk.stats_route_launches["time_major"],
             bk.bwd_route_launches["time_major"])
    if (after[0] - before[0], after[1] - before[1]) != (2, 4):
        raise AssertionError(f"{what}: time-major launches {before} -> {after}")
    return err


def bn_tm_rows(x: torch.Tensor, g: torch.Tensor, flush) -> dict:
    """The time-major kernels at a main path's (x, g) (B, T, C): checked
    (``bn_tm_check``, with and without the cotangents), then timed as
    ``bn_rows`` times the NCW ones, beside the NCW kernels on the same
    values laid NCW (``ncw_run_ms``), and inside a captured CUDA graph,
    whose replays must give the eager launch's bits."""
    err = bn_tm_check(x, g)
    err.update({f"cot_{k}": v for k, v in bn_tm_check(x, g, True).items()})
    B, T, C = x.shape
    n, esize = x.numel(), x.element_size()
    mean = torch.zeros(C, device="cuda")
    invstd = torch.ones(C, device="cuda")
    scale = torch.ones(C, device="cuda")
    xs, gs = copies(x, n * esize), copies(g, n * esize)
    xn, gn = (t.transpose(1, 2).contiguous() for t in (x, g))
    xns, gns = copies(xn, n * esize), copies(gn, n * esize)
    vecs = [scale, mean, invstd, None, None]
    dx = torch.empty_like(x)
    stats = lambda x: bk._launch_stats_tm(x)  # noqa: E731
    bwd = lambda g, x: bk._launch_bwd(g, x, vecs, dx, True)  # noqa: E731
    plan = stats(x)[2]
    row = {"shape": [B, T, C], "dtype": str(x.dtype), "M": n // C,
           "plan": list(plan), "bwd_plan": list(bwd(g, x)[1]),
           "max_abs_err": err,
           "stats": {"kernel_ms": time_ms(lambda: stats(x), flush),
                     "run_ms": run_ms([lambda x=x: stats(x) for x in xs]),
                     "host_us": host_us(lambda: bk.bn_stats(x, True)),
                     "ncw_run_ms": run_ms([lambda x=x: bk.bn_stats(x)
                                           for x in xns]),
                     "bound_ms": bound(n * esize + 2 * C * 4, 3 * n)[0]},
           "bwd": {"kernel_ms": time_ms(lambda: bwd(g, x), flush),
                   "run_ms": run_ms([lambda g=g, x=x: bwd(g, x)
                                     for g, x in zip(gs, xs)]),
                   "ncw_run_ms": run_ms([lambda g=g, x=x: bk.bn_bwd(
                       g, x, scale, mean, invstd) for g, x in zip(gns, xns)]),
                   "sums_only_run_ms": run_ms([lambda g=g, x=x: bk.bn_bwd_stats(
                       g, x, mean, invstd, True) for g, x in zip(gs, xs)]),
                   "dx_run_ms": run_ms([lambda g=g, x=x: bk.bn_bwd_dx(
                       g, x, scale, mean, invstd,
                       torch.zeros(2, C, device="cuda"), n // C,
                       time_major=True) for g, x in zip(gs, xs)]),
                   "bound_ms": bound(3 * n * esize + 5 * C * 4, 12 * n)[0]},
           "graph_replays_bit_identical": bn_tm_graph(x, g)}
    emit({"phase": "bn_time_major", **row})
    return row


def bn_tm_graph(x: torch.Tensor, g: torch.Tensor) -> bool:
    """The cooperative time-major launches captured in a CUDA graph (as a
    train step captures them) and replayed twice: each replay's sums and dx
    must equal an eager launch's bit for bit; raises where they differ."""
    C = x.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(C + 1)
    scale = torch.rand(C, device="cuda", generator=gen) + 0.5
    mean, invstd = (t.contiguous() for t in torch.randn(2, C, device="cuda",
                                                        generator=gen).abs())
    want = (bk.bn_stats(x, True), bk.bn_bwd(g, x, scale, mean, invstd,
                                            time_major=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            bk.bn_stats(x, True)
            bk.bn_bwd(g, x, scale, mean, invstd, time_major=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (bk.bn_stats(x, True), bk.bn_bwd(g, x, scale, mean, invstd,
                                               time_major=True))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        flat = lambda r: [t for part in r for t in part]  # noqa: E731
        for a, b in zip(flat(got), flat(want)):
            if not torch.equal(a, b):
                raise AssertionError(f"time-major {tuple(x.shape)} {x.dtype}: "
                                     "a graph replay differs from the eager "
                                     "launch")
    return True


def phase_bn_time_major(flush) -> dict:
    """The time-major BN route (``bn_tm_rows``) at the bf16 presets' and
    the f32 speech step's shapes, then checked off them (``TM_OFF``)."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows = {}
    for (B, T, Cc), dtype in TM_MAIN:
        x, g = bn_inputs(gen, B, T, Cc, dtype)
        rows[str(dtype)] = bn_tm_rows(x, g, flush)
        del x, g
    for (B, T, Cc), dtype, offset, cot in TM_OFF:
        bn_tm_check(*bn_inputs(gen, B, T, Cc, dtype, offset), cotangents=cot)
    emit({"phase": "bn_time_major", "off_path": len(TM_OFF)})
    return rows


def phase_bn_time_major_step(work: str, seed: int) -> dict:
    """``configs/throughput.yaml`` at full width (bf16, B = 256): the fused
    step's graph replayed ``TM_STEPS`` times.  Each replay must launch 10
    time-major ``bn_stats`` and ``bn_bwd`` and no NCW BN kernel, by the
    launch counters."""
    from meg_decoding_tpu_torch.cli.profile_train_step import speech_step

    cfg, routes = speech_step(work, seed, [], config_name="throughput")
    one = routes["graph"]
    for i in range(3):
        one(i)
    torch.cuda.synchronize()
    reset_all_launches()
    for i in range(TM_STEPS):
        one(3 + i)
    torch.cuda.synchronize()
    want_stats = {**dict.fromkeys(bk.STATS_ROUTES, 0),
                  "time_major": BN_PER_STEP * TM_STEPS}
    want_bwd = {**dict.fromkeys(bk.BWD_ROUTES, 0),
                "time_major": BN_PER_STEP * TM_STEPS}
    if (dict(bk.stats_route_launches) != want_stats
            or dict(bk.bwd_route_launches) != want_bwd):
        raise AssertionError(f"throughput step: BN routes "
                             f"{bk.stats_route_launches} / "
                             f"{bk.bwd_route_launches}, expected {want_stats} "
                             f"/ {want_bwd}")
    out = {"config": "throughput", "compute_dtype": str(cfg.compute_dtype),
           "steps": TM_STEPS, "stats_routes": dict(bk.stats_route_launches),
           "bwd_routes": dict(bk.bwd_route_launches)}
    emit({"phase": "bn_time_major_step", **out})
    return out


# bn_affine's shapes, (B, C, T) and whether time-major: the bf16 presets'
# step (256·360 rows of 320), the f32 step, GOD's in both layouts, and off
# the main paths an odd C and T (no 16-byte vector divides a row) and a base
# one element past 16 bytes
AFFINE_MAIN = (((4 * BATCH, D2, 360), torch.bfloat16, True, 0),
               ((BATCH, D2, 360), torch.float32, False, 0))
AFFINE_OFF = (((BATCH, D2, 24), torch.float32, False, 0),
              ((BATCH, D2, 24), torch.bfloat16, True, 0),
              ((5, 321, 17), torch.float32, False, 0),
              ((5, 321, 17), torch.bfloat16, False, 0),
              ((5, 321, 17), torch.float32, True, 0),
              ((5, 321, 17), torch.bfloat16, True, 0),
              ((BATCH, D2, 360), torch.bfloat16, True, 1))
AFFINE_EPS = 1e-5
AFFINE_STEPS = 3  # replays of each captured step counted


def affine_inputs(gen, shape, dtype, time_major, offset=0):
    """(x, scale, bias, s, ss, M): x on the card in its layout, ``offset``
    elements past an allocation's start, and its sums from ``bn_stats``."""
    B, Cc, T = shape
    x, _ = bn_inputs(gen, B, T, Cc, dtype, offset) if time_major \
        else bn_inputs(gen, B, Cc, T, dtype, offset)
    scale = torch.rand(Cc, device="cuda", generator=gen) + 0.5
    bias = torch.randn(Cc, device="cuda", generator=gen)
    s, ss = bk.bn_stats(x, time_major)
    return x, scale, bias, s, ss, x.numel() // Cc


def affine_check(x, scale, bias, s, ss, M, time_major) -> None:
    """``bn_affine``'s y, mean, var and invstd against the eager chain
    (``bn_affine_plain`` on the card) bit for bit; raises where they
    differ."""
    got = bk.bn_affine(x, scale, bias, s, ss, M, AFFINE_EPS, time_major)
    want = bk.bn_affine_plain(x, scale, bias, s, ss, M, AFFINE_EPS, time_major)
    for name, a, b in zip(("y", "mean", "var", "invstd"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                b.view(torch.int16 if b.element_size() == 2 else torch.int32)):
            raise AssertionError(
                f"bn_affine {tuple(x.shape)} {x.dtype} time_major="
                f"{time_major}: {name} differs from the eager chain")


def phase_bn_affine(flush, work: str) -> dict:
    """``bn_affine`` against the eager op chain it replaced, bit for bit,
    at ``AFFINE_MAIN`` and ``AFFINE_OFF`` and through synced BatchNorm at
    world size 1; at the main shapes the kernel alone and the chain, each
    against the byte bound (x read and y written once)."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = {}
    os.makedirs(work, exist_ok=True)  # the process group's file store
    for shape, dtype, tm, offset in AFFINE_MAIN + AFFINE_OFF:
        affine_check(*affine_inputs(gen, shape, dtype, tm, offset), tm)
    for shape, dtype, tm, _ in AFFINE_MAIN:
        x, scale, bias, s, ss, M = affine_inputs(gen, shape, dtype, tm)
        n, esize = x.numel(), x.element_size()
        xs = copies(x, n * esize)
        least = bound(2 * n * esize + 7 * shape[1] * 4, 2 * n)
        kernel = lambda x: bk.bn_affine(x, scale, bias, s, ss, M,  # noqa: E731
                                        AFFINE_EPS, tm)
        chain = lambda x: bk.bn_affine_plain(  # noqa: E731
            x, scale, bias, s, ss, M, AFFINE_EPS, tm)
        rows[f"{tuple(x.shape)} {dtype}"] = {
            "time_major": tm,
            "kernel_ms": time_ms(lambda: kernel(x), flush),
            "run_ms": run_ms([lambda x=x: kernel(x) for x in xs]),
            "plain_ms": time_ms(lambda: chain(x), flush),
            "plain_run_ms": run_ms([lambda x=x: chain(x) for x in xs]),
            "host_us": host_us(lambda: kernel(x)),
            "bound_ms": least[0], "bound_by": least[1]}
        del x, xs
    # synced BatchNorm at world size 1: the all-reduced sums (unchanged at
    # one rank) and the global M reach the kernel as the local ones would
    mesh, _, _ = dp_group(work, "bn_affine")
    try:
        for shape, dtype, tm, _ in AFFINE_MAIN:
            x, scale, bias, s, ss, M = affine_inputs(gen, shape, dtype, tm)
            got = batch_norm_train(x, scale, bias, AFFINE_EPS, mesh, tm)
            want = bk.bn_affine_plain(x, scale, bias, s, ss, M, AFFINE_EPS, tm)
            for a, b in zip(got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"synced bn_affine {tuple(x.shape)} "
                                         f"{dtype}: differs from the chain")
    finally:
        finish_distributed()
    out = {"checked": len(AFFINE_MAIN) + len(AFFINE_OFF) + len(AFFINE_MAIN),
           "rows": rows}
    emit({"phase": "bn_affine", **out})
    return out


def phase_bn_affine_steps(work: str, seed: int) -> dict:
    """The captured full-width steps, bf16 (``configs/throughput.yaml``,
    time-major) and f32 (``configs/config.yaml``, NCW): each of
    ``AFFINE_STEPS`` replays must launch ``bn_affine`` ``BN_PER_STEP``
    times, as many as ``bn_stats``, by the launch counters."""
    from meg_decoding_tpu_torch.cli.profile_train_step import speech_step

    out = {}
    for name in ("throughput", "config"):
        _, routes = speech_step(os.path.join(work, name), seed, [],
                                config_name=name)
        one = routes["graph"]
        for i in range(3):
            one(i)
        torch.cuda.synchronize()
        reset_all_launches()
        for i in range(AFFINE_STEPS):
            one(3 + i)
        torch.cuda.synchronize()
        replays = graph_counts()["train_replays"]
        want = BN_PER_STEP * AFFINE_STEPS
        if replays != AFFINE_STEPS or bk.launches["bn_affine"] != want \
                or bk.launches["bn_stats"] != want:
            raise AssertionError(f"{name} step: {replays} replays, BN launches "
                                 f"{bk.launches}; expected {want} bn_affine")
        out[name] = {"replays": replays, "launches": dict(bk.launches)}
        del one, routes
    emit({"phase": "bn_affine_steps", **out})
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps; positions where both are NaN count 0."""
    def ordered(x):
        k = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return int(d.max())


def gelu_inputs(shape, dtype, gen, offset: int = 0):
    """(x, g) of ``shape`` on the card, ``offset`` elements past an
    allocation's start: x ~ 2·N(0, 1), which reaches all four intervals of
    erf_poly (|x|/√2 past 1, 2.2 and 3.92), its first values NaN, ±inf, ±0
    and the intervals' edges."""
    n = math.prod(shape) + offset
    x = torch.randn(n, device="cuda", generator=gen) * 2
    g = torch.randn(n, device="cuda", generator=gen)
    edges = [u / gk._SQRT_HALF for u in (1.0, gk._B1, gk._UMAX)]
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                            -0.0, *edges, *(-e for e in edges)], device="cuda")
    k = min(special.numel(), n - offset)
    x[offset:offset + k] = special[:k]
    x, g = x.to(dtype)[offset:], g.to(dtype)[offset:]
    return x.view(shape), g.view(shape)


def gelu_check(x: torch.Tensor, g: torch.Tensor) -> dict:
    """Both GELU kernels on (x, g) against the plain chain: NaNs where the
    chain has them; bf16 equal or 1 ulp apart, f32 within rtol 2e-6 / atol
    1e-6 (the kernels' fmaf Horner steps are the one difference before the
    rounding).  Returns the worst error of each."""
    out = {}
    for name, got, want in (
            ("fwd", gk.gelu_fwd(x), gk.gelu_fwd_plain(x)),
            ("bwd", gk.gelu_bwd(x, g), gk.gelu_bwd_plain(x, g))):
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"gelu {name} {tuple(x.shape)} {x.dtype}: "
                                 "NaNs differ from the plain chain's")
        a, b = got[~nan].float(), want[~nan].float()
        diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
        row = {"max_abs_err": float(diff.max()),
               "equal_share": float((a == b).float().mean())}
        if x.dtype == torch.bfloat16:
            row["max_ulp"] = bf16_ulps(got, want)
            ok = row["max_ulp"] <= 1
        else:
            ok = bool((diff <= 1e-6 + 2e-6 * b.abs()).all())
        if not ok:
            raise AssertionError(f"gelu {name} {tuple(x.shape)} {x.dtype}: "
                                 f"kernel vs plain chain {row}")
        out[name] = row
    return out


def gelu_times(x: torch.Tensor, g: torch.Tensor, flush) -> dict:
    """Each kernel's single launch and run time against its byte bound (x
    read and y written; x and g read and dx written), the plain chain and
    the library's exact-erf GELU (``F.gelu`` and its backward)."""
    es = x.element_size()
    nb = {"fwd": 2 * x.numel() * es, "bwd": 3 * x.numel() * es}
    xs = copies(x, nb["bwd"])
    gs = [g] + [g.clone() for _ in xs[1:]]
    calls = {"fwd": (lambda: gk.gelu_fwd(x), lambda: gk.gelu_fwd_plain(x),
                     lambda: tnf.gelu(x),
                     [lambda a=a: gk.gelu_fwd(a) for a in xs]),
             "bwd": (lambda: gk.gelu_bwd(x, g), lambda: gk.gelu_bwd_plain(x, g),
                     lambda: torch.ops.aten.gelu_backward(g, x),
                     [lambda a=a, b=b: gk.gelu_bwd(a, b) for a, b in zip(xs, gs)])}
    out = {}
    for name, (kernel, plain, library, run) in calls.items():
        out[name] = {"kernel_ms": time_ms(kernel, flush), "run_ms": run_ms(run),
                     "plain_ms": time_ms(plain, flush),
                     "library_ms": time_ms(library, flush), "bytes": nb[name],
                     "bound_ms": nb[name] / HBM_BYTES_PER_S * 1e3}
    del xs, gs
    return out


def phase_gelu(flush) -> dict:
    """The erf_poly GELU's kernels against the plain chain and timed at the
    exact-GELU step's shapes (bf16) and the f32 step's, checked at a numel
    no packet divides, Seq2Static's final GELUs and a base off 16-byte
    alignment; a non-contiguous input is refused.  Returns the timed rows
    and the per-step sums over ``GELU_SITES``."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = {}
    for shape, dtype in ((*((s, torch.bfloat16) for s in GELU_SITES),
                          ((64, 320, 360), torch.float32))):
        x, g = gelu_inputs(shape, dtype, gen)
        checks, times = gelu_check(x, g), gelu_times(x, g, flush)
        row = {"shape": list(shape), "dtype": str(dtype),
               **{k: {**checks[k], **times[k]} for k in checks}}
        emit({"phase": "gelu", **row})
        rows[(shape, str(dtype))] = row
        del x, g
    checked = []
    for shape, dtype, offset in (((1_000_003,), torch.float32, 0),
                                 ((3, 7, 1001), torch.bfloat16, 0),
                                 ((64, 512, 1), torch.bfloat16, 0),
                                 ((64, 512, 1), torch.float32, 0),
                                 ((256, 320, 360), torch.bfloat16, 1),
                                 ((64, 320, 360), torch.float32, 3)):
        x, g = gelu_inputs(shape, dtype, gen, offset)
        checked.append({"shape": list(shape), "dtype": str(dtype),
                        "offset": offset, **gelu_check(x, g)})
    x, g = gelu_inputs((8, 16, 40), torch.bfloat16, gen)
    for call in (lambda: gk.gelu_fwd(x.transpose(1, 2)),
                 lambda: gk.gelu_bwd(x, g.transpose(1, 2).contiguous()
                                     .transpose(1, 2))):
        try:
            call()
        except ValueError as e:
            if "contiguous" not in str(e):
                raise
        else:
            raise AssertionError("gelu: a non-contiguous input was taken")
    bf16 = [(rows[(s, str(torch.bfloat16))], n) for s, n in GELU_SITES.items()]
    per_step = {name: {k: sum(r[name][k] * n for r, n in bf16)
                       for k in ("kernel_ms", "run_ms", "plain_ms",
                                 "library_ms", "bound_ms")}
                for name in ("fwd", "bwd")}
    emit({"phase": "gelu", "off_path": checked, "non_contiguous": "refused",
          "per_step": per_step,
          "per_step_run_ms": sum(v["run_ms"] for v in per_step.values()),
          "per_step_bound_ms": sum(v["bound_ms"] for v in per_step.values())})
    return {"rows": rows, "per_step": per_step}


def moe_check(T: int, E: int, k: int, H: int, gen) -> tuple:
    """The MoE route and combine kernels on T tokens' logits over E experts
    (top k) and rows of H against their plain versions: ids, offsets, rows,
    tokens and the counter equal, weights within 4 f32 ulp (the softmax's
    sum runs in another order); the combine, with and without the shared
    rows, bit for bit.  Returns the inputs the timing reuses."""
    logits = torch.randn(T, E, device="cuda", generator=gen)
    nv = torch.tensor([max(T - 3, 1)], dtype=torch.int32, device="cuda")
    c1 = torch.zeros(E, dtype=torch.int32, device="cuda")
    c2 = torch.zeros(E, dtype=torch.int32, device="cuda")
    got = mk.moe_route(logits, k, nv, c1)
    want = mk.moe_route_plain(logits, k, nv, c2)
    torch.cuda.synchronize()
    for name, a, b in zip(("ids", "offs", "pos", "sorted_token"), got[1:],
                          want[1:]):
        if not torch.equal(a, b.to(a.dtype)):
            raise AssertionError(f"moe_route {T, E, k}: {name} differs")
    if not (torch.allclose(got[0], want[0], rtol=5e-7, atol=0)
            and torch.equal(c1, c2)):
        raise AssertionError(f"moe_route {T, E, k}: weights or counter")
    ys = torch.randn(T * k, H, device="cuda", generator=gen).bfloat16()
    shared = torch.randn(T, H, device="cuda", generator=gen).bfloat16()
    w, pos = got[0], got[3]
    for sh in (shared, None):
        if not torch.equal(mk.moe_combine(ys, pos, w, sh),
                           mk.moe_combine_plain(ys, pos, w, sh)):
            raise AssertionError(f"moe_combine {T, k, H}: differs")
    return logits, nv, c1, ys, pos, w, shared


def phase_moe(flush) -> dict:
    """DeepSeek-V2-Lite's MoE kernels (``csrc/moe_route.cu``) against their
    plain versions at a chunk's shape (``MOE_CHUNK``) and three off-path
    ones, and timed alone at the chunk's: single launch and run against
    the byte bound (``benchmark/benchcore/counts_llm.py``'s), the plain
    version, and the library's nearest calls (route: ``softmax`` +
    ``topk``, without the sort by expert; combine: the gather and weighted
    sum as one einsum)."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    for shape in ((37, 8, 2, 64), (1, 256, 8, 2048), (4096, 64, 6, 1024)):
        moe_check(*shape, gen)
    T, E, k, H = MOE_CHUNK
    logits, nv, c1, ys, pos, w, shared = moe_check(T, E, k, H, gen)
    c2 = c1.clone()
    nb = {"route": 4 * (T * E + T * k * 4 + E),
          "combine": 2 * (T * k * H + 2 * T * H) + 8 * T * k}
    lg, ysc = copies(logits, nb["route"]), copies(ys, nb["combine"])
    calls = {
        "route": (lambda: mk.moe_route(logits, k, nv, c1),
                  lambda: mk.moe_route_plain(logits, k, nv, c2),
                  lambda: torch.topk(torch.softmax(logits, -1), k, dim=-1),
                  [lambda a=a: mk.moe_route(a, k, nv, c1) for a in lg]),
        "combine": (lambda: mk.moe_combine(ys, pos, w, shared),
                    lambda: mk.moe_combine_plain(ys, pos, w, shared),
                    lambda: torch.einsum("tkh,tk->th", ys[pos.long()], w
                                         .bfloat16()),
                    [lambda a=a: mk.moe_combine(a, pos, w, shared)
                     for a in ysc])}
    row = {"shape": [T, E, k, H]}
    for name, (kernel, plain, library, run) in calls.items():
        row[name] = {"kernel_ms": time_ms(kernel, flush), "run_ms": run_ms(run),
                     "plain_ms": time_ms(plain, flush),
                     "library_ms": time_ms(library, flush),
                     "bytes": nb[name],
                     "bound_ms": nb[name] / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "moe", **row})
    del lg, ysc
    return row


def kda_check(C: int, H: int, gen) -> dict:
    """The KDA kernel against its plain chunked form (the same bf16
    roundings) on q, k, v strided as the layer passes them: outputs and the
    f32 state within 1e-2 of their largest (an intermediate may round to
    the neighbouring bf16: the kernel sums in other orders); the convolution
    kernel against its plain version (within an ulp of bf16, the tail
    exactly)."""
    x = torch.randn(C, 3, H, 128, device="cuda", generator=gen).bfloat16()
    g = -torch.rand(C, H, 128, device="cuda", generator=gen) * 0.5
    b = torch.rand(C, H, device="cuda", generator=gen)
    s0 = torch.randn(H, 128, 128, device="cuda", generator=gen) * 0.1
    s1, s2 = s0.clone(), s0.clone()
    got = kk.kda_chunk(x[:, 0], x[:, 1], x[:, 2], g, b, s1)
    want = kk.kda_chunk_plain(x[:, 0], x[:, 1], x[:, 2], g, b, s2)
    torch.cuda.synchronize()
    o_gap = float((got.float() - want.float()).abs().max()
                  / want.float().abs().max())
    s_gap = float((s1 - s2).abs().max() / s2.abs().max())
    if not (o_gap <= 1e-2 and s_gap <= 1e-2):
        raise AssertionError(f"kda_chunk {C, H}: o {o_gap}, state {s_gap}")
    p = x.reshape(C, 3 * H * 128)
    w = (torch.randn(3 * H * 128, 1, 4, device="cuda", generator=gen)
         * 0.5).bfloat16()
    t1 = torch.randn(3, 3 * H * 128, device="cuda", generator=gen).bfloat16()
    t2 = t1.clone()
    cg, cw = kk.short_conv(p, t1, w), kk.short_conv_plain(p, t2, w)
    torch.cuda.synchronize()
    if not (torch.equal(t1, t2) and bool(((cg.float() - cw.float()).abs()
                                          <= 2 ** -7 * cw.float().abs()
                                          + 1e-30).all())):
        raise AssertionError(f"short_conv {C, 3 * H * 128}: differs")
    return {"shape": [C, H], "o_gap": o_gap, "state_gap": s_gap}


def kimi_graph_check(seed: int) -> dict:
    """A small Kimi-Linear (hidden 256, one period and a KDA layer, KDA
    heads 2 of 128, 16 experts of which 8 held) through ``text_llm`` on the
    card: a 3-chunk document of 2,048-token chunks, its first pass (each
    chunk position captured, the carried state put back after each
    warm-up), replays its chunk graphs and equals the eager forward
    (within 1e-2 of the largest feature; whether bit for bit is printed),
    with one ``kda_chunk`` and one ``kda_conv`` launch a KDA
    layer a chunk and one route and one combine a MoE layer, and the
    expert counter holding each real token once."""
    from meg_decoding_tpu_torch.features import kimi_linear_model as km
    from meg_decoding_tpu_torch.features import text_llm
    from meg_decoding_tpu_torch.train import graph as graph_mod

    la = {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5],
          "head_dim": 128, "num_heads": 2, "short_conv_kernel_size": 4}
    cfg = km.KimiLinearConfig(
        vocab_size=4096, hidden_size=256, intermediate_size=512,
        moe_intermediate_size=128, num_hidden_layers=5,
        num_attention_heads=2, num_experts=16, num_experts_per_token=4,
        kv_lora_rank=64, experts_held=8, linear_attn_config=la)
    with torch.device("cuda"):
        m = km.KimiLinearModel(cfg).eval().requires_grad_(False)
    m.init_random(torch.Generator(device="cuda").manual_seed(seed))
    ids = torch.randint(0, 4096, (5000,), generator=torch.Generator()
                        .manual_seed(seed))
    ends = np.arange(2, 5001, 2)
    torch.backends.cudnn.deterministic = True
    reset_launches()
    replays = graph_mod.replays["forward"]
    got = text_llm.embed_words_last4_avg(m, ids, ends, 2048, 8192)
    torch.cuda.synchronize()
    n_replays = graph_mod.replays["forward"] - replays
    counts = launch_counts()
    per = {k[2]: n for k, n in counts.items()
           if k[0] in ("kda", "moe") and k[2] is not None}
    held = m.expert_counts.sum(1).tolist()
    want = []
    m.allocate(8192)
    for s in range(0, 6144, 2048):
        buf = torch.zeros(2048, dtype=torch.int64, device="cuda")
        n = min(2048, 5000 - s)
        buf[:n] = ids[s:s + n].to("cuda")
        hs = m(buf, m.positions[:s + 2048],
               torch.tensor([n], dtype=torch.int32, device="cuda"))
        want.append(torch.stack([h.float() for h in hs]).mean(0)[:n])
    want = text_llm.word_mean(torch.cat(want), ends).T
    gap = float((got - want).abs().max() / want.abs().max())
    if gap > 1e-2:
        raise AssertionError(f"kimi chunk graphs: graph != eager, {gap}")
    expect = {"kda_chunk": 12, "kda_conv": 12, "moe_route": 12,
              "moe_combine": 12}
    if n_replays != 3 or any(per.get(k) != v for k, v in expect.items()) \
            or held != [5000 * 4] * 4:
        raise AssertionError(f"kimi chunk graphs: replays {n_replays}, "
                             f"launches {per}, counted pairs {held}")
    return {"replays": n_replays, "launches": per, "graph_vs_eager": gap,
            "bit_identical": bool(torch.equal(got, want))}


def phase_kimi(flush, seed: int) -> dict:
    """Kimi-Linear's kernels: the KDA chunk and convolution against their
    plain versions at the cell's shape (``KIMI_CHUNK``) and two off-path
    ones, the sigmoid route with its selection bias and half the experts
    held against its plain version and DeepSeek-V2's call, then each timed
    alone at the cell's shape: single launch and run against the byte
    bound (``benchmark/benchcore/counts_kimi.py``'s), the plain version,
    and the library's nearest call (KDA: none computes a delta rule; the
    convolution: cuDNN's depthwise conv2d on the channels-last view and
    SiLU; the route: sigmoid + ``topk``, without the sort by expert); then
    a small model's chunk graphs (``kimi_graph_check``)."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    T, H, E, k, Hd, held = KIMI_CHUNK
    checked = [kda_check(C, h, gen) for C, h in ((100, 3), (1, 2))]
    checked.append(kda_check(T, H, gen))
    for first in (0, E - held):
        logits = torch.randn(T, E, device="cuda", generator=gen)
        bias = torch.randn(E, device="cuda", generator=gen) * 0.02
        nv = torch.tensor([T - 3], dtype=torch.int32, device="cuda")
        c1 = torch.zeros(E, dtype=torch.int32, device="cuda")
        c2 = c1.clone()
        kw = dict(bias=bias, renormalize=True, scale=2.446, first=first,
                  held=held)
        got = mk.moe_route(logits, k, nv, c1, **kw)
        want = mk.moe_route_plain(logits, k, nv, c2, **kw)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b.to(a.dtype))
                    for a, b in zip(got[1:], want[1:]))
                and torch.allclose(got[0], want[0], rtol=5e-7, atol=0)
                and torch.equal(c1, c2)):
            raise AssertionError(f"sigmoid route held from {first}: differs")
    x = torch.randn(T, 3, H, 128, device="cuda", generator=gen).bfloat16()
    g = -torch.rand(T, H, 128, device="cuda", generator=gen) * 0.5
    b = torch.rand(T, H, device="cuda", generator=gen)
    state = torch.zeros(H, 128, 128, device="cuda")
    p = x.reshape(T, 3 * H * 128)
    w = (torch.randn(3 * H * 128, 1, 4, device="cuda", generator=gen)
         * 0.5).bfloat16()
    tail = torch.zeros(3, 3 * H * 128, dtype=torch.bfloat16, device="cuda")
    nb = {"kda_chunk": T * H * (4 * 128 * 2 + 128 * 4 + 4)
          + 2 * H * 128 * 128 * 4,
          "kda_conv": 2 * 2 * T * 3 * H * 128 + 2 * 3 * H * 128 * 4,
          "route": 4 * (T * E + T * k * 4 + E)}
    xs, ps, lg = copies(x, nb["kda_chunk"]), copies(p, nb["kda_conv"]), \
        copies(logits, nb["route"])
    x4 = p.T[None, :, None, :]  # the channels-last view, as the conv reads it

    def conv_library():
        return tnf.silu(tnf.conv2d(x4, w.view(-1, 1, 1, 4), groups=w.shape[0],
                                   padding=(0, 3))[..., :T])

    calls = {
        "kda_chunk": (lambda: kk.kda_chunk(x[:, 0], x[:, 1], x[:, 2], g, b,
                                           state),
                      lambda: kk.kda_chunk_plain(x[:, 0], x[:, 1], x[:, 2],
                                                 g, b, state),
                      None,
                      [lambda a=a: kk.kda_chunk(a[:, 0], a[:, 1], a[:, 2], g,
                                                b, state) for a in xs]),
        "kda_conv": (lambda: kk.short_conv(p, tail, w),
                     lambda: kk.short_conv_plain(p, tail, w), conv_library,
                     [lambda a=a: kk.short_conv(a, tail, w) for a in ps]),
        "route": (lambda: mk.moe_route(logits, k, nv, c1, **kw),
                  lambda: mk.moe_route_plain(logits, k, nv, c2, **kw),
                  lambda: torch.topk(torch.sigmoid(logits) + bias, k, dim=-1),
                  [lambda a=a: mk.moe_route(a, k, nv, c1, **kw)
                   for a in lg])}
    row = {"shape": list(KIMI_CHUNK), "checked": checked}
    for name, (kernel, plain, library, run) in calls.items():
        row[name] = {"kernel_ms": time_ms(kernel, flush),
                     "run_ms": run_ms(run),
                     "plain_ms": time_ms(plain, flush, reps=3),
                     "library_ms": (None if library is None
                                    else time_ms(library, flush)),
                     "bytes": nb[name],
                     "bound_ms": nb[name] / HBM_BYTES_PER_S * 1e3}
    row["per_chunk_run_ms"] = {
        "kda_chunk": row["kda_chunk"]["run_ms"] * KIMI_KDA_LAYERS,
        "kda_conv": row["kda_conv"]["run_ms"] * KIMI_KDA_LAYERS,
        "route": row["route"]["run_ms"] * KIMI_MOE_LAYERS}
    del xs, ps, lg
    row["graphs"] = kimi_graph_check(seed)
    emit({"phase": "kimi", **row})
    return row


def adam_list(kind: str, gen) -> tuple:
    """(params, grads) of the speech or GOD encoder's parameter list at the
    benchmark configurations' widths and the temperature, as lists on the
    card; gradients N(0, 1)·1e-3."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    C_, S, F_, seq2seq = ADAM_LISTS[kind]
    loc = np.random.RandomState(0).rand(C_, 2).astype(np.float32)
    model = BrainEncoder(loc, S, D1=270, D2=D2, F=F_, K=32, seq2seq=seq2seq,
                         num_blocks=5, device="cuda", generator=gen)
    params = [p.detach() for p in model.parameters()]
    params.append(torch.tensor(5.1, device="cuda"))
    grads = [torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
             for p in params]
    return params, grads


def adam_scalars(count: int) -> tuple:
    """``Adam._update``'s (neg_lr, c1, c2) at ``count`` updates done, lr
    3e-3, on the card."""
    inc = torch.tensor(count + 1, dtype=torch.int32, device="cuda")
    neg_lr = -torch.full((), 3e-3, device="cuda")
    return (neg_lr, 1 - ak.B1 ** inc.to(torch.float32),
            1 - ak.B2 ** inc.to(torch.float32))


def adam_check(params, grads, gen) -> dict:
    """The kernel (``adam_update``) against the eager chain
    (``adam_update_plain``) on clones, ``ADAM_STEPS`` steps with fresh
    gradients, the fourth skipped (``ok`` false) and the first tensor's
    gradient None: p, mu and nu bit for bit after every step, one launch
    a step and no chain."""
    P = [p.clone() for p in params]
    MU = [torch.zeros_like(p) for p in params]
    NU = [torch.zeros_like(p) for p in params]
    P2, MU2, NU2 = ([t.clone() for t in ts] for ts in (P, MU, NU))
    ak.reset_launches()
    for i in range(ADAM_STEPS):
        G = [None] + [torch.randn(g.shape, device="cuda", generator=gen)
                      * 10.0 ** (i % 5 - 4) for g in grads[1:]]
        ok = torch.tensor(i != 3, device="cuda")
        scalars = adam_scalars(i if i <= 3 else i - 1)  # step 3 undone
        ak.adam_update(P, G, MU, NU, *scalars, ok)
        ak.adam_update_plain(P2, G, MU2, NU2, *scalars, ok)
        torch.cuda.synchronize()
        for what, a, b in (("p", P, P2), ("mu", MU, MU2), ("nu", NU, NU2)):
            for j, (x, y) in enumerate(zip(a, b)):
                if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                    raise AssertionError(f"adam step {i}: {what} of tensor "
                                         f"{j} {tuple(x.shape)} differs from "
                                         "the eager chain")
    want = {"multi_tensor": ADAM_STEPS, "eager": 0}
    if ak.launches != want:
        raise AssertionError(f"adam launches {ak.launches}, expected {want}")
    return {"steps": ADAM_STEPS, "bit_equal": True, "skipped_step": 3,
            "none_grad": 0}


def adam_library(params, grads, mus, nus, count: int = 1):
    """torch.optim.Adam's foreach route (``_foreach_*`` ops, host-float
    step sizes, no skipped step) on the same lists: the yardstick."""
    bc1, bc2 = 1 - ak.B1 ** count, 1 - ak.B2 ** count

    def run():
        torch._foreach_lerp_(mus, grads, 1 - ak.B1)
        torch._foreach_mul_(nus, ak.B2)
        torch._foreach_addcmul_(nus, grads, grads, 1 - ak.B2)
        den = torch._foreach_sqrt(nus)
        torch._foreach_div_(den, math.sqrt(bc2))
        torch._foreach_add_(den, ak.EPS)
        torch._foreach_addcdiv_(params, mus, den, -3e-3 / bc1)
    return run


def phase_adam(flush) -> dict:
    """Adam's multi-tensor kernel (``csrc/adam.cu``) on the speech and GOD
    encoders' parameter lists: bit for bit against the eager chain over
    ``ADAM_STEPS`` steps (``adam_check``), then timed alone (single and
    run) against its byte bound (p, g, mu, nu read and p, mu, nu written:
    28 bytes an element), the eager chain ("plain"), torch.optim.Adam's
    ``_foreach_*`` route ("library") and the wrapper's host time a call."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    rows = {}
    for kind in ADAM_LISTS:
        params, grads = adam_list(kind, gen)
        check = adam_check(params, grads, gen)
        mus = [torch.rand(p.shape, device="cuda", generator=gen) * 1e-3
               for p in params]
        nus = [torch.rand(p.shape, device="cuda", generator=gen) * 1e-6
               for p in params]
        ok = torch.ones((), dtype=torch.bool, device="cuda")
        scalars = adam_scalars(1)
        numel = sum(p.numel() for p in params)
        nbytes = 28 * numel
        kernel = lambda: ak.adam_update(params, grads, mus, nus,  # noqa: E731
                                        *scalars, ok)
        plain = lambda: ak.adam_update_plain(  # noqa: E731
            params, grads, mus, nus, *scalars, ok)
        row = {"tensors": len(params), "elements": numel,
               "launches_a_call": len(ak.plan([p.numel() for p in params])),
               "check": check, "kernel_ms": time_ms(kernel, flush),
               "run_ms": run_ms([kernel]), "plain_ms": time_ms(plain, flush),
               "library_ms": time_ms(adam_library(params, grads, mus, nus),
                                     flush),
               "host_us": host_us(kernel), "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        row["run_share_of_bound"] = row["bound_ms"] / row["run_ms"]
        emit({"phase": "adam", "list": kind, **row})
        rows[kind] = row
        del params, grads, mus, nus
    return rows


def adam_launches(path: str, updates: int) -> dict:
    """``adam.launches`` since ``reset_all_launches()``: one kernel launch
    an update and no eager chain, or raises."""
    want = {"multi_tensor": updates, "eager": 0}
    if ak.launches != want:
        raise AssertionError(f"{path}: adam launches {ak.launches}, expected "
                             f"{want}")
    return dict(ak.launches)


def phase_adam_steps(work: str, seed: int) -> dict:
    """The captured full-width steps of the training cells' routes: the
    bf16 speech step (``configs/throughput.yaml``), the f32 one
    (``configs/config.yaml``) and GOD's per-step step (``config_GOD.yaml``):
    each of ``AFFINE_STEPS`` replays must launch Adam's kernel once and
    the eager chain never."""
    from meg_decoding_tpu_torch.cli.profile_train_step import god_step, speech_step

    out = {}
    for name, make in (("throughput", speech_step), ("config", speech_step),
                       ("config_GOD", god_step)):
        _, routes = make(os.path.join(work, name), seed, [], config_name=name)
        one = routes["graph"]
        for i in range(3):
            one(i)
        torch.cuda.synchronize()
        reset_all_launches()
        for i in range(AFFINE_STEPS):
            one(3 + i)
        torch.cuda.synchronize()
        replays = graph_counts()["train_replays"]
        if replays != AFFINE_STEPS:
            raise AssertionError(f"{name} step: {replays} replays, expected "
                                 f"{AFFINE_STEPS}")
        out[name] = {"replays": replays,
                     "adam": adam_launches(f"{name} step", AFFINE_STEPS)}
        del one, routes
    emit({"phase": "adam_steps", **out})
    return out


def phase_gelu_step(work: str, seed: int) -> dict:
    """``configs/throughput_exact.yaml`` at full width (bf16, B = 256, the
    cached collate statistics, erf_poly GELU): the fused step through
    ``train_route``, as ``fit`` runs it, for ``GELU_STEPS`` replays of its
    graph, each of which must launch each GELU kernel ``GELU_PER_STEP``
    times and no step run eagerly."""
    cfg, ds, tr_idx = full_width_speech(
        work, seed, [f"save_root={os.path.join(work, 'exact')}"],
        config_name="throughput_exact")
    dev = torch.device("cuda")
    B = int(cfg.batch_size)
    collate = evaluate_speech.collate_config(cfg)
    table = compute_collate_stats(ds, collate.baseline_len_samp,
                                  chunk=SWEEP_CHUNK)
    model = get_model(cfg, ch_locations_2d(cfg), device=dev, seed=seed,
                      num_channels=int(ds.recordings.shape[2]))
    opt = make_optimizer(cfg, GELU_STEPS)
    state = create_train_state(model, opt, float(cfg.init_temperature), seed)
    fused = make_fused_speech_step(model, opt, train_speech.loss_config(cfg),
                                   collate, ds, collate_stats=table)
    route = loop.train_route(fused, state)
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    rng = np.random.RandomState(seed + 5)
    reset_all_launches()
    losses = []
    for i in range(GELU_STEPS):
        m = route(pool.segment_ids(rng.randint(0, len(pool), B)),
                  generator=torch.Generator().manual_seed(seed * 1000 + i))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    want = {"gelu_fwd": GELU_PER_STEP * GELU_STEPS,
            "gelu_bwd": GELU_PER_STEP * GELU_STEPS}
    counts = graph_counts()
    if dict(gk.launches) != want or counts["train_replays"] != GELU_STEPS:
        raise AssertionError(f"exact step: gelu launches {gk.launches}, "
                             f"graphs {counts}; expected {want} from "
                             f"{GELU_STEPS} replays")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"exact step losses {losses}")
    out = {"compute_dtype": str(cfg.compute_dtype), "batch_size": B,
           "gelu": str(cfg.get("gelu_impl")), "replays": GELU_STEPS,
           "launches": dict(gk.launches), "graphs": counts, "losses": losses}
    emit({"phase": "gelu_step", **out})
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
    # the requests replay one graph of the forward, the eval CLI its own
    # forward's one graph a pool
    replays = graph_replays("serving", 0, N_REQUESTS + results["n_pools"], 2)

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
          "eval": results, "launches": launches, "graph": replays})
    return launches


def reset_all_launches() -> None:
    reset_launches()
    tg.reset_counts()


def all_launches() -> dict:
    return {"window_gather": wg.launches, "robust_quantiles": qk.launches,
            **bk.launches}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / abs(b)


def phase_training(cfg, ds, tr_idx, seed, work) -> dict:
    """One step on the card against the CPU, a few fused steps' losses,
    then the main path: the train CLI for one epoch.  Returns its launch
    counts."""
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
    state, m = step(state, X, Y, subs, centre=centre)
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
    losses = []
    for i in range(FUSED_STEPS):
        idx = pool.segment_ids(rng.randint(0, len(pool), BATCH))
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        state, m = fused(state, idx, generator=gen)
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
                "bn_affine": BN_PER_STEP * TRAIN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * TRAIN_UPDATES}
    if launches != expected:
        raise AssertionError(f"train CLI launches {launches}, expected {expected}")
    adam = adam_launches("train CLI", TRAIN_UPDATES)
    replays = graph_replays("train CLI", TRAIN_UPDATES, pools)
    emit({"phase": "training", "card_vs_cpu": check, "rel_err_limit": 1e-4,
          "fused_losses": losses, "train_cli_s": run_s, "adam": adam,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "train_top1", "train_top10",
                                             "test_loss", "test_top1",
                                             "test_top10")},
          "test_pools": pools, "launches": launches, "graph": replays,
          "bn_stats_routes": dict(bk.stats_route_launches),
          "bn_bwd_sums_only_launches": bk.sums_only_launches})
    return {"launches": launches, "stats_routes": dict(bk.stats_route_launches),
            "adam": adam}


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
    """One GOD train step on the card against the same step on the CPU, a
    few per-step losses, then the main path: ``cli/train_god.py`` for one
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
    state, m = step(state, X, Y, subs, centre=centre)
    cpu_step = make_train_step(cpu_model, cpu_opt, loss_cfg, collate_cfg)
    _, mc = cpu_step(cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=centre)
    check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
             "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
        raise AssertionError(f"card vs CPU GOD train step: {check}")

    # the per-step form as fit runs it: gather from the packed set + step
    rng = np.random.RandomState(seed)
    losses = []
    for i in range(FUSED_STEPS):
        idx = rng.randint(0, len(ds), BATCH)
        state, m = step(state, *ds.gather(idx)[:3])
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
                "bn_affine": BN_PER_STEP * updates,
                "bn_bwd_stats": BN_PER_STEP * updates}
    if launches != expected:
        raise AssertionError(f"GOD train CLI launches {launches}, expected {expected}")
    adam = adam_launches("GOD train CLI", updates)
    replays = graph_replays("GOD train CLI", updates, pools)
    emit({"phase": "god_training", "card_vs_cpu": check, "rel_err_limit": 1e-4,
          "losses": losses, "train_cli_s": run_s, "updates": updates,
          "adam": adam,
          "test_pools": pools,
          "train_cli": {k: best[k] for k in (
              "train_loss", "train_skipped", "train_top1", "train_top10",
              "test_loss", "test_top1", "test_top10")},
          "launches": launches, "graph": replays,
          "bn_stats_routes": dict(bk.stats_route_launches),
          "bn_bwd_sums_only_launches": bk.sums_only_launches})
    return {"launches": launches, "stats_routes": dict(bk.stats_route_launches),
            "adam": adam}


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
                "bn_affine": 0, "bn_bwd_stats": 0}
    if launches != expected:
        raise AssertionError(f"GOD eval CLI launches {launches}, expected {expected}")
    # that predict batch is one replay of the forward's graph
    replays = graph_replays("GOD eval CLI", 0, 1)
    emit({"phase": "god_eval", "eval": results, "eval_cli_s": eval_s,
          "launches": launches, "graph": replays})
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
    loss cached vs inline, a few fused steps' losses, then the main path:
    the train CLI for one epoch of each preset.  Returns the CLIs' launch
    counts."""
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
            "bn_stats": 0, "bn_affine": 0, "bn_bwd_stats": 0}
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
           "b256_bn": bn256, "launches": {}, "gelu_launches": {}}
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
        # a few fused steps with the cached statistics
        model, opt, state = fresh()
        fused = make_fused_speech_step(model, opt, loss_cfg, pcollate, ds,
                                       collate_stats=table)
        losses = []
        for i in range(PRESET_STEPS):
            sidx = pool.segment_ids(rng.randint(0, len(pool), B))
            gen = torch.Generator().manual_seed(seed * 1000 + i)
            state, m = fused(state, sidx, generator=gen)
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
                    "bn_affine": BN_PER_STEP * PRESET_UPDATES,
                    "bn_bwd_stats": BN_PER_STEP * PRESET_UPDATES}
        if launches != expected:
            raise AssertionError(f"{preset} CLI launches {launches}, "
                                 f"expected {expected}")
        # erf_poly GELU: its kernels at each site of every update's replay
        # and of every test pool's forward
        sites = GELU_PER_STEP if pcfg.get("gelu_impl") == "erf_poly" else 0
        want_gelu = {"gelu_fwd": sites * (PRESET_UPDATES + pools),
                     "gelu_bwd": sites * PRESET_UPDATES}
        if gk.launches != want_gelu:
            raise AssertionError(f"{preset} CLI GELU launches {gk.launches}, "
                                 f"expected {want_gelu}")
        out["gelu_launches"][preset] = dict(gk.launches)
        replays = graph_replays(f"{preset} CLI", PRESET_UPDATES, pools)
        if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
            raise AssertionError(f"{preset} CLI: {best}")
        out["launches"][preset] = launches
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
              "losses": losses, "train_cli_s": run_s, "test_pools": pools, "launches": launches,
              "gelu_launches": out["gelu_launches"][preset],
              "graph": replays,
              "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                                 "test_loss", "test_top10")}})
    return out


def compare_epochs(run_epoch, run_steps) -> dict:
    """The epoch form against the per-step path, both from one init and
    draws, cuDNN deterministic (the same kernels on the same inputs), run
    in turns (epoch, per-step, per-step, epoch; the first run pays the
    deterministic algorithms' set-up), the epoch runs timed: mean loss
    within 1e-5 relative, every state entry within 1e-5 of its tensor's
    max |p|, for every run against the first epoch."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        epoch_s, results = [], []
        for run in (run_epoch, run_steps, run_steps, run_epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, means = run()
            means = {k: float(v) for k, v in means.items()}
            torch.cuda.synchronize()
            if run is run_epoch:
                epoch_s.append(time.perf_counter() - t0)
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
    return {"epoch_s": epoch_s, "epoch_means": a, "per_step_means": results[1][1],
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
                "bn_affine": BN_PER_STEP * SCAN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * SCAN_UPDATES}
    if launches != expected:
        raise AssertionError(f"scan CLI launches {launches}, expected {expected}")
    replays = graph_replays("scan CLI", SCAN_UPDATES, pools)
    if best.get("train_skipped") != 0.0 or "t_step_ms" in best:
        raise AssertionError(f"scan CLI: {best}")
    emit({"phase": "scan_epochs", "workload": "speech", "updates": SCAN_UPDATES,
          "batch_size": BATCH, **check, "train_cli_s": run_s,
          "test_pools": pools, "launches": launches, "graph": replays,
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
                "bn_affine": BN_PER_STEP * SCAN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * SCAN_UPDATES}
    if launches != expected:
        raise AssertionError(f"GOD scan CLI launches {launches}, expected {expected}")
    replays = graph_replays("GOD scan CLI", SCAN_UPDATES, pools)
    if best.get("train_skipped") != 0.0 or "t_step_ms" in best:
        raise AssertionError(f"GOD scan CLI: {best}")
    emit({"phase": "scan_epochs", "workload": "god", "updates": SCAN_UPDATES,
          "batch_size": BATCH, **check, "train_cli_s": run_s,
          "test_pools": pools, "launches": launches, "graph": replays,
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")}})
    return launches


GRAPH_STEPS = 6        # same-draw steps of each step path (graphs phase)
GRAPH_EPOCHS = 2       # same-draw epochs of SCAN_UPDATES of each epoch path
GRAPH_RTOL = 1e-5      # graph vs eager: the same kernels on the same inputs
GRAPH_PROFILE_STEPS = 4  # a route's profile: steps timed, then as many traced


def state_entries(state) -> dict:
    """Every tensor of a train state by name: parameters and BN buffers,
    Adam's moments and count, the step."""
    sd = state.state_dict()
    return {**sd["params"], **{f"mu.{k}": v for k, v in sd["opt"]["mu"].items()},
            **{f"nu.{k}": v for k, v in sd["opt"]["nu"].items()},
            "opt.count": sd["opt"]["count"], "step": sd["step"]}


def rel_diff(got: dict, want: dict) -> tuple[float, bool]:
    """Largest max|Δ| / max|want| over the entries of two dicts of tensors
    (of a tensor that is 0 in ``want``: max|Δ|), and whether every entry is
    bit-identical."""
    worst, same = 0.0, True
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        same = same and torch.equal(g, w)
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-30))
    return worst, same


def per_unit(delta: dict, units: int) -> dict:
    """Launch counts of a run, a unit (step or update): exact or raises."""
    out = {}
    for k, n in delta.items():
        if n % units:
            raise AssertionError(f"{k}: {n} launches over {units} steps")
        if n:
            out[":".join(str(p) for p in k if p is not None)] = n // units
    return out


def graph_route_profile(cfg, one, per_call: int) -> dict:
    """``profile_train_step.profile_config`` of one route (one untimed
    call, then GRAPH_PROFILE_STEPS steps timed and as many traced, in calls
    of ``per_call`` steps), by step: steady ms, device operations, busy
    ms, idle share of the traced window and of the kernels' span."""
    r = profile_config(cfg, one, 1, max(GRAPH_PROFILE_STEPS // per_call, 1))
    return {"step_ms": r["step_ms_median"] / per_call,
            "device_ops_per_step": r["device_ops_per_step"] / per_call,
            "busy_ms_per_step": r["busy_ms_per_step"] / per_call,
            "idle_share_of_window": r["idle_share_of_window"],
            "idle_share_of_kernel_span": r["idle_share_of_kernel_span"],
            "top_kernels": r["top_kernels"][:3]}


def graph_path(name: str, cfg, make, calls: int, per_call: int,
               smi: str) -> dict:
    """One path of the ``graphs`` phase.  ``make()`` builds one train state
    and returns ``(state, eager(i), graphed(i), graph_of())``: call i of
    the eager route and of the graph route on that state (a step, or an
    epoch of ``per_call`` updates) on draw i, each returning its metrics,
    and the route's ``GraphedStep``.  Two states from one init take the
    same ``calls`` draws, cuDNN deterministic: state and metrics within
    GRAPH_RTOL of each tensor's max, launches a step equal, one replay a
    step, the graph route's calls timed; then, with cuDNN's default
    algorithms, the graph route's profile (captured again)."""
    t_path = time.perf_counter()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for route in ("eager", "graph"):
            state, eager, graphed, graph_of = make()
            fn = eager if route == "eager" else graphed
            reset_all_launches()
            before = launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, hist = [], []
            for i in range(calls):
                t0 = time.perf_counter()
                m = fn(i)
                torch.cuda.synchronize()
                if route == "graph":
                    ms.append((time.perf_counter() - t0) * 1e3 / per_call)
                hist.append({k: v.detach().clone() for k, v in m.items()})
            after = launch_counts()
            runs[route] = {
                "state": state, "fn": fn, "graph_of": graph_of, "ms": ms,
                "hist": hist, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": per_unit({k: after[k] - before[k] for k in after},
                                     calls * per_call),
                "replays": tg.replays["train"],
                "captures": tg.captures["train"]}
    finally:
        torch.backends.cudnn.deterministic = prev
    e, g = runs["eager"], runs["graph"]
    state_rel, state_same = rel_diff(state_entries(g["state"]),
                                     state_entries(e["state"]))
    metrics_rel, metrics_same = rel_diff(
        {k: torch.stack([h[k] for h in g["hist"]]) for k in g["hist"][0]},
        {k: torch.stack([h[k] for h in e["hist"]]) for k in e["hist"][0]})
    if not (state_rel <= GRAPH_RTOL and metrics_rel <= GRAPH_RTOL):
        raise AssertionError(f"graphs {name}: graph vs eager state {state_rel}, "
                             f"metrics {metrics_rel}")
    if any(float(h["skipped"]) != 0.0 for h in e["hist"] + g["hist"]):
        raise AssertionError(f"graphs {name}: a step was skipped")
    if g["launches"] != e["launches"] or not e["launches"]:
        raise AssertionError(f"graphs {name}: launches a step, graph "
                             f"{g['launches']} vs eager {e['launches']}")
    if (e["replays"], g["replays"], g["captures"]) != (0, calls * per_call, 1):
        raise AssertionError(f"graphs {name}: replays eager {e['replays']}, "
                             f"graph {g['replays']}, captures {g['captures']}")
    capture_s = g["graph_of"]().capture_seconds
    for r in (e, g):  # free both states and the graph before the profile
        del r["state"], r["fn"], r["graph_of"]
    _, _, graphed, graph_of = make()
    profile = graph_route_profile(cfg, graphed, per_call)
    profile["capture_s"] = graph_of().capture_seconds
    del graphed, graph_of
    row = {"phase": "graphs", "path": name, "device": smi,
           "steps": calls * per_call, "cudnn_deterministic_check": True,
           "state_rel_err": state_rel, "state_bit_identical": state_same,
           "metrics_rel_err": metrics_rel,
           "metrics_bit_identical": metrics_same, "limit": GRAPH_RTOL,
           "graph_ms": g["ms"], "graph_ms_median": float(np.median(g["ms"][1:])),
           "capture_s": capture_s, "launches_per_step": e["launches"],
           "replays": g["replays"], "peak_gb": {"eager": e["peak_gb"],
                                                "graph": g["peak_gb"]},
           "profile": profile, "seconds": time.perf_counter() - t_path}
    emit(row)
    return row


def phase_graphs_speech(cfg, ds, tr_idx, seed, smi: str) -> dict:
    """Paths (a)–(c) of the ``graphs`` phase: the fused speech step at
    ``configs/config.yaml``'s width (f32, B = 64), the same under
    ``configs/throughput.yaml`` as published (bf16, B = 256, the cached
    collate statistics), and ``make_gwilliams_scan_epoch``."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    Cx = int(ds.recordings.shape[2])
    out = {}
    pcfg = compose(CONFIGS_DIR, "throughput", [f"cache_dir={cfg.cache_dir}",
                                               f"seed={seed}"])
    pcfg.num_subjects = ds.num_subjects
    table = compute_collate_stats(ds, evaluate_speech.collate_config(
        pcfg).baseline_len_samp)
    for name, c, stats in (("a_fused_speech_f32_b64", cfg, None),
                           ("b_throughput_bf16_b256", pcfg, table)):
        B = int(c.batch_size)
        rng = np.random.RandomState(seed + 11)
        idx = [pool.segment_ids(rng.randint(0, len(pool), B))
               for _ in range(GRAPH_STEPS)]

        def make(c=c, stats=stats, idx=idx):
            model = get_model(c, loc, device=dev, seed=seed, num_channels=Cx)
            opt = make_optimizer(c, int(c.updates))
            state = create_train_state(model, opt, float(c.init_temperature),
                                       seed)
            step = make_fused_speech_step(
                model, opt, train_speech.loss_config(c),
                evaluate_speech.collate_config(c), ds, collate_stats=stats)
            graphed = GraphedStep(step.body, state)
            gen = lambda i: torch.Generator().manual_seed(seed * 1000 + i)
            return (state,
                    lambda i: step(state, idx[i % len(idx)], gen(i))[1],
                    lambda i: graphed(step.prepare(state, idx[i % len(idx)],
                                                   gen(i))),
                    lambda: graphed)

        out[name] = graph_path(name, c, make, GRAPH_STEPS, 1, smi)
    del table

    rng = np.random.RandomState(seed + 12)
    draws = [(torch.as_tensor(np.stack([
        pool.segment_ids(rng.randint(0, len(pool), BATCH))
        for _ in range(SCAN_UPDATES)]), device=dev),
        torch.randint(0, ds.num_sessions, (SCAN_UPDATES, BATCH), device=dev,
                      generator=torch.Generator(dev).manual_seed(seed + e)))
        for e in range(GRAPH_EPOCHS)]

    def make_epoch():
        model = get_model(cfg, loc, device=dev, seed=seed, num_channels=Cx)
        opt = make_optimizer(cfg, SCAN_UPDATES)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        epoch = make_gwilliams_scan_epoch(
            model, opt, train_speech.loss_config(cfg),
            evaluate_speech.collate_config(cfg), ds, SCAN_UPDATES, BATCH)
        run = lambda i, f: f(state, idx=draws[i % GRAPH_EPOCHS][0],
                             sess_ids=draws[i % GRAPH_EPOCHS][1])[1]
        return (state, lambda i: run(i, epoch.eager), lambda i: run(i, epoch),
                lambda: epoch.graphed)

    out["c_gwilliams_scan_epoch"] = graph_path(
        "c_gwilliams_scan_epoch", cfg, make_epoch, GRAPH_EPOCHS, SCAN_UPDATES,
        smi)
    return out


def phase_graphs_god(cfg, ds, seed, smi: str) -> dict:
    """Paths (d) and (e) of the ``graphs`` phase: ``make_scan_epoch`` on
    ``configs/config_GOD.yaml``'s brain encoder, and ``fit``'s step with
    ``model=eegnet`` (its two dropout masks drawn on the host)."""
    dev = torch.device("cuda")
    cfg.num_subjects = ds.num_subjects
    out = {}
    draws = [torch.randint(0, len(ds), (SCAN_UPDATES, BATCH), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed + e))
             for e in range(GRAPH_EPOCHS)]
    loc = ch_locations_2d(cfg, roi(cfg))

    def make_epoch():
        model = get_model(cfg, loc, device=dev, seed=seed, num_channels=len(loc))
        opt = make_optimizer(cfg, SCAN_UPDATES)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        epoch = make_scan_epoch(model, opt, train_god._loss_config(cfg),
                                evaluate_speech.collate_config(cfg), ds,
                                SCAN_UPDATES, BATCH)
        run = lambda i, f: f(state, idx=draws[i % GRAPH_EPOCHS])[1]
        return (state, lambda i: run(i, epoch.eager), lambda i: run(i, epoch),
                lambda: epoch.graphed)

    out["d_god_scan_epoch"] = graph_path("d_god_scan_epoch", cfg, make_epoch,
                                         GRAPH_EPOCHS, SCAN_UPDATES, smi)

    zcfg = Config(to_dict(cfg))
    zcfg.model = "eegnet"
    zloc = ch_locations_2d(zcfg, roi(zcfg))
    rng = np.random.RandomState(seed + 13)
    batches = [ds.gather(rng.randint(0, len(ds), BATCH))[:3]
               for _ in range(GRAPH_STEPS)]

    def make_eegnet():
        model = get_model(zcfg, zloc, device=dev, seed=seed,
                          num_channels=len(zloc))
        opt = make_optimizer(zcfg, int(zcfg.updates))
        state = create_train_state(model, opt, float(zcfg.init_temperature),
                                   seed)
        step = make_train_step(model, opt, train_god._loss_config(zcfg),
                               evaluate_speech.collate_config(zcfg))
        graphed = GraphedStep(step.body, state)
        return (state,
                lambda i: step(state, *batches[i % GRAPH_STEPS])[1],
                lambda i: graphed(step.prepare(state,
                                               *batches[i % GRAPH_STEPS])),
                lambda: graphed)

    out["e_god_fit_eegnet"] = graph_path("e_god_fit_eegnet", zcfg, make_eegnet,
                                         GRAPH_STEPS, 1, smi)
    return out


def graph_counts() -> dict:
    """The graph replays and captures by kind since
    ``reset_all_launches()``."""
    return {f"{kind}_{what}": counts[kind] for kind in tg.KINDS
            for what, counts in (("replays", tg.replays),
                                 ("captures", tg.captures))}


def graph_replays(path: str, train: int, forward: int,
                  forward_graphs: int | None = None,
                  got: dict | None = None) -> dict:
    """The graph replays and captures by kind since
    ``reset_all_launches()`` (or ``got``, read earlier): ``train`` train
    step replays (the steps taken on the graph route; 0 on an eager route)
    after one capture where there was a replay, and ``forward`` forward
    replays (test pools, eval batches, requests) after ``forward_graphs``
    captures (one where there was a replay, by default)."""
    got = graph_counts() if got is None else got
    want = {"train_replays": train, "train_captures": int(train > 0),
            "forward_replays": forward,
            "forward_captures": (int(forward > 0) if forward_graphs is None
                                 else forward_graphs)}
    if got != want:
        raise AssertionError(f"{path}: graphs {got}, expected {want}")
    return got


SERVE_GRAPH_BATCHES = (1, 8, 64)  # serve_graphs: the serving benchmark's sizes
SERVE_GRAPH_ITERS = 30            # timed requests, then as many traced
SERVE_CPU_ROWS = 8                # rows of a request held against the CPU
FIT_EPOCHS, FIT_UPDATES = 2, 2    # serve_graphs: fit graph vs eager (GOD)


class EagerStep:
    """A stand-in for ``GraphedStep``: the body run eagerly on the inputs
    (host inputs copied to the device), so that ``fit`` runs both of its
    routes eagerly for a comparison."""

    def __init__(self, body, state=None, device="cuda", reads=(), mesh=None):
        self.body, self.state = body, state
        self.device = torch.device(device) if state is None else state.step.device

    def __call__(self, inputs):
        inputs = to_device(inputs, self.device, non_blocking=True)
        if self.state is None:
            return self.body(**inputs)
        return self.body(self.state, **inputs)


def z_of(out) -> torch.Tensor:
    """Z of a forward's output (Z) or an eval step's ((metrics, Z))."""
    return out[1] if isinstance(out, tuple) else out


def serve_graph_path(name: str, make, X, subs, cpu_Z, smi: str) -> dict:
    """One path of ``serve_graphs`` at one batch.  ``make()`` returns
    ``(eager, graphed, graph_of)``: ``eager(X, subs)`` and ``graphed(X,
    subs)`` run the path eagerly and through its graph, each returning Z
    or ``(metrics, Z)``, and ``graph_of()`` is the route's ``GraphedStep``.
    Under cuDNN's deterministic algorithms: the graph's first call (the
    capture) and a replay bit-identical to the eager call, each with the
    eager call's launches, two forward replays after one capture; card vs
    CPU (``cpu_Z``, the first rows) within CARD_CPU_RTOL of max|Z|.  Then,
    with the default algorithms and a new graph: the graph route's request
    ms, device operations and busy ms a request and idle share, peak memory
    and the capture's seconds."""
    t_path = time.perf_counter()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, graphed, graph_of = make()
        eager(X, subs)  # the libraries' first call of these shapes
        torch.cuda.synchronize()
        marks, outs = [launch_counts()], []
        counts0 = graph_counts()
        for fn in (eager, graphed, graphed):
            outs.append(fn(X, subs))
            torch.cuda.synchronize()
            marks.append(launch_counts())
        counts1 = graph_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    launches = [per_unit({k: b[k] - a[k] for k in b}, 1)
                for a, b in zip(marks, marks[1:])]
    if not launches[0] or launches[1:] != [launches[0]] * 2:
        raise AssertionError(f"serve_graphs {name}: launches eager, capture "
                             f"call, replay {launches}")
    counts = {k: counts1[k] - counts0[k] for k in counts1}
    if counts != {"train_replays": 0, "train_captures": 0,
                  "forward_replays": 2, "forward_captures": 1}:
        raise AssertionError(f"serve_graphs {name}: graphs {counts}")
    want = torch.utils._pytree.tree_leaves(outs[0])
    for out in outs[1:]:
        got = torch.utils._pytree.tree_leaves(out)
        if len(got) != len(want) or not all(map(torch.equal, got, want)):
            raise AssertionError(f"serve_graphs {name}: graph vs eager not "
                                 "bit-identical under deterministic cuDNN")
    Z = z_of(outs[0])
    if not bool(torch.isfinite(Z).all()):
        raise AssertionError(f"serve_graphs {name}: Z not finite")
    cpu_err = rel_max(Z[:cpu_Z.shape[0]].cpu(), cpu_Z)
    if not cpu_err <= CARD_CPU_RTOL:
        raise AssertionError(f"serve_graphs {name}: card vs CPU {cpu_err}")
    del eager, graphed, graph_of, outs, Z

    _, graphed, graph_of = make()
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph = {**latency_row(graphed, X, subs, SERVE_GRAPH_ITERS, dev),
             **request_profile(graphed, X, subs, SERVE_GRAPH_ITERS, dev),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "capture_s": graph_of().capture_seconds}
    row = {"phase": "serve_graphs", "path": name, "device": smi,
           "batch": int(X.shape[0]), "cudnn_deterministic_check": True,
           "bit_identical": True, "card_vs_cpu_rel_err": cpu_err,
           "card_vs_cpu_limit": CARD_CPU_RTOL,
           "cpu_rows": int(cpu_Z.shape[0]), "launches_per_call": launches[0],
           "graphs": counts, "graph": graph,
           "seconds": time.perf_counter() - t_path}
    emit(row)
    return row


def serve_graph_paths(workload: str, model, cpu_model, n_channels: int,
                      seq_len: int, n_subjects: int, collate, loss_cfg,
                      pool, temp: float, seed: int, work: str, smi: str) -> dict:
    """``serve_graphs`` for one encoder: the serving forward and its
    exported artifact at each of SERVE_GRAPH_BATCHES, and the eval step on
    one test pool ``pool`` = (X, Y, subs).  Returns the rows."""
    dev = torch.device("cuda")
    out = os.path.join(work, f"serve_graphs_{workload}")
    save_artifact(out, model, n_channels, seq_len, collate,
                  extra_meta={"num_subjects": n_subjects})
    card = load_artifact(out, device="cuda")
    body = make_serving_forward(collate).body
    rng = np.random.RandomState(seed + 17)
    reads = [*model.parameters(), *model.buffers()]

    def cpu_ref(X, subs):
        k = min(int(X.shape[0]), SERVE_CPU_ROWS)
        return body(cpu_model, X[:k].cpu(), subs[:k].cpu())

    def forward_route():
        fw = make_serving_forward(collate)
        return (lambda x, s: fw.body(model, x, s),
                lambda x, s: fw(model, x, s), lambda: fw.graphs[model])

    def artifact_route():
        served = ServingModel(card.program, card.weights, card.meta, dev)
        return served.body, served, lambda: served.graphed

    rows = {}
    for B in SERVE_GRAPH_BATCHES:
        X = torch.from_numpy(rng.randn(B, n_channels, seq_len)
                             .astype(np.float32)).to(dev)
        subs = torch.from_numpy(rng.randint(0, n_subjects, B)
                                .astype(np.int32)).to(dev)
        ref = cpu_ref(X, subs)
        for kind, make in (("forward", forward_route),
                           ("artifact", artifact_route)):
            name = f"{workload}_{kind}_b{B}"
            rows[name] = serve_graph_path(name, make, X, subs, ref, smi)

    X, Y, subs = pool
    step = make_eval_step(model, loss_cfg, collate)
    t = torch.tensor(float(temp), device=dev)

    def eval_route():
        g = GraphedStep(step.body, device=dev, reads=reads)
        return (lambda x, s: step(x, Y, s, t),
                lambda x, s: g(step.prepare(x, Y, s, t)), lambda: g)

    name = f"{workload}_eval_step_b{int(X.shape[0])}"
    rows[name] = serve_graph_path(name, eval_route, X, subs, cpu_ref(X, subs),
                                  smi)
    return rows


def phase_serve_graphs_speech(cfg, ds, tr_idx, seed, work, smi: str) -> dict:
    """``serve_graphs`` on ``configs/config.yaml``'s seq2seq encoder at full
    width (C = 208, T = 360, F = 1024), the inline collate on; the eval
    step on the first BATCH windows of the test split."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    model = get_model(cfg, loc, device=dev, seed=seed)
    cpu_model = get_model(cfg, loc, device="cpu", seed=seed)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    te_idx = np.setdiff1d(np.arange(len(ds)), np.asarray(tr_idx))
    pool = evaluate_speech.SpeechPool(ds, te_idx, seed=seed).gather(
        np.arange(BATCH))
    return serve_graph_paths(
        "speech", model, cpu_model, C, int(ds.seq_len), int(ds.num_subjects),
        evaluate_speech.collate_config(cfg), train_speech.loss_config(cfg),
        pool, float(cfg.init_temperature), seed, work, smi)


def phase_serve_graphs_god(cfg, ds, seed, work, smi: str) -> dict:
    """``serve_graphs`` on ``configs/config_GOD.yaml``'s brain encoder
    (22 ROI channels, T = 24, F = 512, mean-pooled); the eval step on the
    last BATCH windows of the train split; then ``fit`` with its train and
    eval graphs against ``fit`` with both routes eager (``EagerStep``)
    from one init on the same draws, cuDNN deterministic: FIT_EPOCHS
    epochs of FIT_UPDATES updates, the end state and every epoch's
    metrics bit-identical, each route's replays and launches."""
    dev = torch.device("cuda")
    cfg.num_subjects = ds.num_subjects
    loc = ch_locations_2d(cfg, roi(cfg))
    model = get_model(cfg, loc, device=dev, seed=seed, num_channels=len(loc))
    cpu_model = get_model(cfg, loc, device="cpu", seed=seed,
                          num_channels=len(loc))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_cfg = train_god._loss_config(cfg)
    if loss_cfg.kind == "classification":
        raise AssertionError("serve_graphs takes config_GOD.yaml's CLIP loss")
    collate = evaluate_speech.collate_config(cfg)
    pool = ds.gather(np.arange(len(ds) - BATCH, len(ds)))[:3]
    rows = serve_graph_paths(
        "god", model, cpu_model, len(loc), int(ds.X.shape[-1]),
        int(ds.num_subjects), collate, loss_cfg, pool,
        float(cfg.init_temperature), seed, work, smi)
    del model, cpu_model

    fcfg = Config(dict(to_dict(cfg), epochs=FIT_EPOCHS, updates=FIT_UPDATES,
                       use_sampler=True, batch_size=BATCH, test_size=BATCH))
    test = ds.subset(np.arange(len(ds) - 100, len(ds)))
    pools = len(_test_pool_starts(len(test), BATCH, True))
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("graph", "eager"):
            model = get_model(fcfg, loc, device=dev, seed=seed,
                              num_channels=len(loc))
            opt = make_optimizer(fcfg, FIT_UPDATES)
            state = create_train_state(model, opt,
                                       float(fcfg.init_temperature), seed)
            logger = RunLogger(os.path.join(work, f"fit_{route}"),
                               run_name="fit")
            if route == "eager":
                loop.GraphedStep = EagerStep
            reset_all_launches()
            try:
                state, _ = loop.fit(
                    fcfg, ds, test, state,
                    make_train_step(model, opt, loss_cfg, collate),
                    make_eval_step(model, loss_cfg, collate), logger,
                    seed=seed)
            finally:
                loop.GraphedStep = GraphedStep
            torch.cuda.synchronize()
            with open(logger.path) as f:
                logged = [{k: v for k, v in json.loads(line).items()
                           if k.startswith(("train_", "test_"))} for line in f]
            runs[route] = {"state": state_entries(state), "rows": logged,
                           "launches": all_launches(),
                           "graphs": graph_replays(
                               f"fit {route}",
                               FIT_EPOCHS * FIT_UPDATES if route == "graph" else 0,
                               FIT_EPOCHS * pools if route == "graph" else 0)}
    finally:
        torch.backends.cudnn.deterministic = prev
    g, e = runs["graph"], runs["eager"]
    state_rel, state_same = rel_diff(g["state"], e["state"])
    if not state_same or g["rows"] != e["rows"] or g["launches"] != e["launches"]:
        raise AssertionError(f"serve_graphs fit: graph vs eager state "
                             f"{state_rel}, rows {g['rows']} vs {e['rows']}, "
                             f"launches {g['launches']} vs {e['launches']}")
    fit_row = {"phase": "serve_graphs", "path": "god_fit_graph_vs_eager",
               "epochs": FIT_EPOCHS, "updates": FIT_UPDATES,
               "test_pools": pools, "cudnn_deterministic_check": True,
               "state_bit_identical": True, "rows_bit_identical": True,
               "rows": g["rows"], "launches": g["launches"],
               "graphs": g["graphs"]}
    emit(fit_row)
    rows["god_fit"] = fit_row
    return rows


def phase_model_zoo(god_cfg, god_ds, seed, flush) -> dict:
    """The GOD train CLI with ``model=eegnet`` at config_GOD.yaml's EEGNet
    hyper-parameters, then ``model=brain_endcoder_seq2static`` with
    ``window.end=0.6`` (T = 48) at D1 = 270, D2 = 320, F = 512; for each,
    the first step on the card against the CPU (loss and global gradient
    norm within 1e-4; EEGNet's dropout masks come from the state's CPU
    generator, the same on both); then the BN kernels at EEGNet's three
    shapes and Seq2Static's five.  Returns each CLI's launch counts."""
    dev = torch.device("cuda")
    launches_by_model, routes_by_model, rows = {}, {}, {}
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
        _, m = make_train_step(model, opt, loss_cfg, collate)(
            state, X, Y, subs, centre=0)
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
                    "bn_stats": n_bn * updates, "bn_affine": n_bn * updates,
                    "bn_bwd_stats": n_bn * updates}
        if launches != expected:
            raise AssertionError(f"{name} CLI launches {launches}, expected {expected}")
        replays = graph_replays(f"{name} CLI", updates, pools)
        if best.get("train_skipped") != 0.0 or not (
                math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])):
            raise AssertionError(f"{name} CLI: {best}")
        launches_by_model[name] = launches
        routes_by_model[name] = dict(bk.stats_route_launches)
        emit({"phase": "model_zoo", "model": name, "T": int(ds.X.shape[2]),
              "card_vs_cpu": check, "rel_err_limit": 1e-4,
              "train_cli_s": run_s,
              "updates": updates, "test_pools": pools, "launches": launches,
              "graph": replays,
              "bn_stats_routes": routes_by_model[name],
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
    return {"launches": launches_by_model, "stats_routes": routes_by_model,
            "bn": rows}


# Brennan2018 at the scale of the real dataset: 33 usable subjects × 60
# EEG channels × a 742 s (12.4 min) audiobook recording at 500 Hz, a
# 1024-wide embedding stream at 120 Hz (89,040 samples): rows of 88,920
# keys a subject's channel after the shift and the trim, 33 times that
# pooled
BRENNAN = dict(S=33, C=60, fs=500.0, rec_sec=742.0, F=1024, rate=120.0)
BRENNAN_DATA_RTOL = 1e-5   # card vs CPU: f32 FFTs of 371,000 samples, two libraries
BRENNAN_CHECK_SUBJECTS = 3
BRENNAN_ROW_KEYS = 88_920  # a subject's channel after the build's shift and trim
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


def launch_split(fn, calls: int = 3) -> dict:
    """The device work of one call of ``fn``, launch by launch: calls
    (after one untimed), each under torch.profiler, until ``calls`` of them
    traced the same kernels, memsets and copies (a trace that lost events,
    as a profiler's first sessions in a process can, is dropped and
    counted: ``dropped_traces``); those launches in the order they ran,
    and the median duration of each in ms (``pass_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    os.makedirs(os.path.join(ROOT, "runs_out"), exist_ok=True)
    path = os.path.join(ROOT, "runs_out", f"launch_split_{os.getpid()}.json")
    traces: dict[tuple, list] = {}
    for _ in range(calls + 6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = sorted((e["ts"], e["dur"], e["name"])
                        for e in json.load(f)["traceEvents"]
                        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
        names = tuple(re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
                      for _, _, n in ev)
        traces.setdefault(names, []).append([d / 1e3 for _, d, _ in ev])
        if len(traces[names]) == calls and names:
            break
    os.remove(path)
    names, durs = max(traces.items(), key=lambda kv: (len(kv[1]), len(kv[0])))
    if len(durs) < calls or not names:
        raise AssertionError(f"launch_split: no {calls} calls traced alike: "
                             f"{ {k: len(v) for k, v in traces.items()} }")
    return {"launches_per_call": len(names), "launch_names": list(names),
            "pass_ms": [float(v) for v in np.median(durs, axis=0)],
            "dropped_traces": sum(len(v) for v in traces.values()) - len(durs)}


def long_traffic(x2d: torch.Tensor) -> dict:
    """The bytes the long-row path moves for ``x2d``: two full reads, the
    candidate keys its second read writes and its last pass reads back
    twice (``qk.long_candidates``), a third full read for each row whose
    list passes the cap, and the output.  An older checkout's path, timed
    in turns with ``--phase brennan_kernels``, keeps no lists: it reads the
    rows 4 times and its candidate figures are None."""
    N, T = x2d.shape
    if not hasattr(qk, "long_candidates"):
        return {"candidate_bytes": None, "third_read_rows": None,
                "moved_bytes": 4 * N * T * 4 + N * 3 * 4}
    counts = qk.long_candidates(x2d).cpu()
    cand = int(counts.clamp(min=0).sum())
    third = int((counts < 0).sum())
    return {"candidate_bytes": 4 * cand, "third_read_rows": third,
            "moved_bytes": (2 * N * T + third * T + 3 * cand) * 4 + N * 3 * 4}


def long_quantile_case(x2d: torch.Tensor, flush, what: str,
                       hard_rows: bool = True) -> dict:
    """The long-row path on (N, T) rows (with the hard rows unless
    ``hard_rows`` is False): against the plain version (0 ulp, equal NaN
    positions), timed as the other kernels are, its device time split by
    launch (``launch_split``) and its traffic (``long_traffic``).  The
    bound is one read of the rows (the function's least traffic);
    ``design_floor_ms`` is the traffic this design moves for these rows
    at the same rate."""
    N, T = x2d.shape
    if qk.kernel_route(T) != "global":
        raise AssertionError(f"{what}: rows of {T} keys do not take the "
                             "global-memory path")
    if hard_rows:
        x2d = with_hard_rows(x2d)
    before = qk.long_launches
    got, want, ulps = quantile_check(x2d)
    if qk.long_launches != before + 1:
        raise AssertionError(f"{what}: the long-row kernel did not launch")
    if ulps != 0:
        raise AssertionError(f"{what}: {ulps} ulp from the plain version; "
                             "the long-row path is exact")
    split = launch_split(lambda: qk.robust_quantiles(x2d))
    want_launches = getattr(qk, "LONG_PASSES", None)
    if want_launches is not None and split["launches_per_call"] != want_launches:
        raise AssertionError(f"{what}: a call launched {split['launch_names']}, "
                             f"expected {want_launches} kernels")
    traffic = long_traffic(x2d)
    fin = torch.isfinite(got) & torch.isfinite(want)
    q_lib = torch.tensor([0.25, 0.5, 0.75], device="cuda")
    lib_ms, lib_note = library_time(
        lambda: torch.quantile(x2d, q_lib, dim=1), flush)
    nbytes = N * T * 4 + N * 3 * 4
    row = {"at": what, "shape": [N, T], "tolerance": "0 ulp",
           "max_ulp": ulps,
           "max_abs_err": float((got[fin] - want[fin]).abs().max())
           if bool(fin.any()) else 0.0,
           "kernel_ms": time_ms(lambda: qk.robust_quantiles(x2d), flush,
                                reps=10),
           "run_ms": run_ms([lambda x=x: qk.robust_quantiles(x)
                             for x in copies(x2d, nbytes)], n=16, reps=3),
           **split,
           "plain_ms": time_ms(lambda: qk.robust_quantiles_plain(x2d), flush,
                               reps=5),
           "library_ms": lib_ms, "library_refused": lib_note,
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **traffic,
           "design_floor_ms": traffic["moved_bytes"] / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "brennan_kernels", "kernel": "robust_quantiles_long", **row})
    return row


def phase_brennan_kernels(row_len: int, flush) -> dict:
    """The quantile kernel's global-memory path against its plain version
    on the card: hard rows at T = 58,113 (just past the shared-memory
    path), Brennan's subject-wise rows (S·C rows of ``row_len``) and its
    pooled rows (C rows of S·``row_len``), then at the subject-wise shape
    an input quantized as an ADC quantizes EEG (``round(randn·200)/10``:
    few distinct values, long runs of equal keys) and a constant input
    (every key equal: the lists pass the cap, a third full read)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    S, Cb = BRENNAN["S"], BRENNAN["C"]
    sw = (S * Cb, row_len)
    out = {}
    for what, shape in (("T=58113", (BATCH, qk.SHARED_MAX_T + 1)),
                        ("subject-wise", sw),
                        ("pooled", (Cb, S * row_len))):
        out[what] = long_quantile_case(
            torch.randn(shape, device="cuda", generator=g), flush, what)
    out["subject-wise quantized"] = long_quantile_case(
        torch.round(torch.randn(sw, device="cuda", generator=g) * 200) / 10,
        flush, "subject-wise quantized", hard_rows=False)
    out["subject-wise constant"] = long_quantile_case(
        torch.full(sw, 1.5, device="cuda"), flush, "subject-wise constant",
        hard_rows=False)
    quantile_long_edges(g)
    return out


def quantile_long_edges(g) -> None:
    """The long-row path off Brennan's shapes, each against the plain
    version (0 ulp): one quantile, and four with ranks 0 and T − 1 that do
    not interpolate; rows of odd length and a base 4 bytes past a 16-byte
    boundary (the scalar heads and tails); then every zeroed scratch the
    calls left behind must be zero again."""
    for (n, t), qs, offset in (((9, 58_113), (50.0,), 0),
                               ((9, 100_003), (0.0, 33.3, 99.99, 100.0), 0),
                               ((9, 65_536), (25.0, 50.0, 75.0), 1)):
        buf = torch.randn(n * t + offset, device="cuda", generator=g)
        x2d = with_hard_rows(buf[offset:].view(n, t))
        got = qk.robust_quantiles(x2d, qs)
        want = qk.robust_quantiles_plain(x2d, qs)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)) \
                or ulp_distance(got, want) != 0:
            raise AssertionError(f"robust_quantiles {(n, t)} qs {qs} offset "
                                 f"{offset}: not the plain version's")
    for buf in getattr(qk, "_ZEROED", {}).values():
        if int(torch.count_nonzero(buf)) != 0:
            raise AssertionError("the long-row path left its zeroed scratch "
                                 "nonzero")


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
                "bn_affine": 0, "bn_bwd_stats": 0, "robust_quantiles_long": 1}
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
    gradient norm within 1e-4), then the step replayed as a CUDA graph, as
    ``fit`` runs it: its steady time and device operations a step
    (``profile_train_step.profile_config``).  Returns the launch counts of
    the timed steps."""
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
    state, m = step(state, X, Y, subs, centre=0)
    _, mc = make_train_step(cpu_model, cpu_opt, loss_cfg, collate)(
        cpu_state, X.cpu(), Y.cpu(), subs.cpu(), centre=0)
    check = {"loss_rel_err": rel_err(m["loss"], mc["loss"]),
             "grad_norm_rel_err": rel_err(m["grad_norm"], mc["grad_norm"]),
             "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_norm_rel_err"] <= 1e-4):
        raise AssertionError(f"card vs CPU Brennan train step: {check}")
    del cpu_model, cpu_opt, cpu_state

    rng = np.random.RandomState(seed)
    graphed = GraphedStep(step.body, state)

    def one_graph(i):
        idx = rng.randint(0, len(pool), BATCH)
        return graphed(step.prepare(state, *pool.gather(
            idx, generator=torch.Generator().manual_seed(i))))

    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    gprof = profile_config(cfg, one_graph, warmup=2, steps=5)
    launches = brennan_launches()
    graph = {k: gprof[k] for k in ("step_ms_median", "device_ops_per_step",
                                   "busy_ms_per_step", "idle_share_of_window",
                                   "max_memory_gb")}
    graph["capture_s"] = graphed.capture_seconds
    emit({"phase": "brennan_training", "card_vs_cpu": check,
          "rel_err_limit": 1e-4, "graph": graph,
          "width": {"C": cfg.num_channels, "S": cfg.num_subjects,
                    "D1": int(cfg.D1), "D2": int(cfg.D2), "K": int(cfg.K),
                    "F": int(Y.shape[1]), "T": int(X.shape[2]), "B": BATCH},
          "launches": launches})
    return {"launches": launches}


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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = cli.run(brennan_cfg(seed, overrides), device="cuda")
        torch.cuda.synchronize()
        result[name] = {"seconds": time.perf_counter() - t0,
                        "launches": brennan_launches(), "result": res,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "graph": graph_counts()}
    # the train CLI's test pools are the eval CLI's pools (one split)
    pools = result["eval"]["result"]["n_pools"]
    for name, train in (("train", BRENNAN_UPDATES), ("eval", 0)):
        graph_replays(f"Brennan {name} CLI", train, pools,
                      got=result[name]["graph"])
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
                      "bn_affine": BN_PER_STEP * BRENNAN_UPDATES,
                      "bn_bwd_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "robust_quantiles_long": 1},
            "eval": {"window_gather": 0, "robust_quantiles": 0, "bn_stats": 0,
                     "bn_affine": 0, "bn_bwd_stats": 0,
                     "robust_quantiles_long": 1}}
    for name in want:
        if result[name]["launches"] != want[name]:
            raise AssertionError(f"Brennan {name} CLI launches "
                                 f"{result[name]['launches']}, expected {want[name]}")
    emit({"phase": "brennan_cli", "write_s": write_s, **BRENNAN_CLI,
          "updates": BRENNAN_UPDATES, "train_cli_s": result["train"]["seconds"],
          "eval_cli_s": result["eval"]["seconds"],
          "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                             "test_loss", "test_top10")},
          "eval": ev, "launches": {k: r["launches"] for k, r in result.items()},
          "graph": {k: r["graph"] for k, r in result.items()},
          "peak_gb": {k: r["peak_gb"] for k, r in result.items()}})
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
                "bn_affine": BN_PER_STEP * TRAIN_UPDATES,
                "bn_bwd_stats": BN_PER_STEP * TRAIN_UPDATES}
    if launches != expected:
        raise AssertionError(f"unfused CLI launches {launches}, expected {expected}")
    replays = graph_replays("unfused CLI", TRAIN_UPDATES, pools)
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"unfused CLI: {best}")
    emit({"phase": "unfused_step", "rel_err": check, "limit": 1e-5,
          "loss": float(metrics["fused"]["loss"]), "train_cli_s": run_s,
          "test_pools": pools, "launches": launches, "graph": replays,
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
    CPU, the full model's last-4 average over the 45 s clip through its
    chunk graph against the same chunks run eagerly (bit for bit, cuDNN
    deterministic), then the full model over 742 s of 16 kHz audio
    (Brennan's length): the last-4 average (its chunks counted as the
    chunk graph's replays) and the conv features, timed."""
    from meg_decoding_tpu_torch.features import wav2vec
    from meg_decoding_tpu_torch.features.wav2vec2_model import Wav2Vec2Model
    from meg_decoding_tpu_torch.train import graph

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

    # graph vs eager: a fresh capture under deterministic cuDNN, dropped
    # afterwards so that the timed run below captures at the defaults
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    chunk_forward = wav2vec.chunk_forward
    try:
        wav2vec._graphs.pop(model, None)
        replays = graph.replays["forward"]
        graphed = wav2vec.embed_last4_avg(model, long_clip)
        graph_chunks = graph.replays["forward"] - replays
        body = wav2vec.chunk_forward(model).body
        wav2vec.chunk_forward = lambda m: (lambda inputs: body(**inputs))
        eager = wav2vec.embed_last4_avg(model, long_clip)
    finally:
        wav2vec.chunk_forward = chunk_forward
        torch.backends.cudnn.deterministic = prev
        wav2vec._graphs.pop(model, None)
    if graph_chunks != 3 or not torch.equal(graphed, eager):
        raise AssertionError(f"wav2vec2 chunk graph vs eager over "
                             f"{W2V_CHUNKED_SEC} s: {graph_chunks} replays, "
                             f"max |Δ| {float((graphed - eager).abs().max())}")
    del graphed, eager
    wav2vec.embed_last4_avg(model, long_clip)  # the timed run's capture

    wav = audio(W2V_LONG_SEC)
    # embed_last4_avg's defaults: 20 s chunks, 1 s (50 frames) of overlap
    chunk = 20 * 16000 // model.config.stride * model.config.stride
    n_chunks = len(wav2vec._chunk_plan(model.config, wav.numel(), chunk, 50))
    out = {}
    for name, fn in (("last4", wav2vec.embed_last4_avg),
                     ("features", wav2vec.embed_features)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        replays = graph.replays["forward"]
        t0 = time.perf_counter()
        emb = fn(model, wav)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        chunks = graph.replays["forward"] - replays
        if not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"wav2vec2 {name} over {W2V_LONG_SEC} s: not finite")
        flops = (chunks * w2v_flops(model.config, chunk) if name == "last4"
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
        if name == "last4":
            if chunks != n_chunks:
                raise AssertionError(f"wav2vec2 last4 over {W2V_LONG_SEC} s: "
                                     f"{chunks} chunk-graph replays, "
                                     f"{n_chunks} chunks")
            out[name]["chunks"] = chunks
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
           "rel_err_limit": FEATURE_RTOL,
           "graph_vs_eager": {"sec": W2V_CHUNKED_SEC, "chunks": graph_chunks,
                              "bit_identical": True},
           "long_sec": W2V_LONG_SEC,
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
                      "bn_affine": BN_PER_STEP * BRENNAN_UPDATES,
                      "bn_bwd_stats": BN_PER_STEP * BRENNAN_UPDATES,
                      "robust_quantiles_long": 1},
            "eval": {"window_gather": 0, "robust_quantiles": 0, "bn_stats": 0,
                     "bn_affine": 0, "bn_bwd_stats": 0,
                     "robust_quantiles_long": 1}}
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
                    "bn_affine": 0, "bn_bwd_stats": 0}
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
    per_update = {"bn_stats": BN_PER_STEP * 2, "bn_affine": BN_PER_STEP * 2,
                  "bn_bwd_stats": BN_PER_STEP * 2}
    for name, k in (("train", 1), ("sweep", 2)):
        got = result[name]["launches"]
        if any(got[b] != k * n for b, n in per_update.items()) \
                or got["window_gather"] != k or got["robust_quantiles"] < 3 * k:
            raise AssertionError(f"{name} launches {got}")
    if result["evaluate"]["launches"] != {
            "window_gather": 2, "robust_quantiles": 1, "bn_stats": 0,
            "bn_affine": 0, "bn_bwd_stats": 0}:
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
    scaled weight and the latency rows of the graph and the artifact."""
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
                    "bn_affine": 0, "bn_bwd_stats": 0} \
            or qk.long_launches != 0:
        raise AssertionError(f"{name} artifact call launches {launches}")
    key = "conv_final2.weight"
    w = card.weights[key]
    card.weights[key] = w * 1.5
    scaled = card(X, subs)
    card.weights[key] = w
    restored = card(X, subs)
    if torch.equal(scaled, Z):
        raise AssertionError(f"{name}: a weight scaled by 1.5 left Z as it was")
    if not torch.equal(restored, Z):
        raise AssertionError(f"{name}: the restored weight does not give "
                             "back the first Z bit for bit")
    rows = []
    for B in BENCH_BATCHES:
        X, subs = request(B)
        for source, call in (
                ("graph", lambda x, s: forward(model, x, s)),
                ("artifact", card)):
            rows.append({"source": source,
                         **latency_row(call, X, subs, BENCH_ITERS, dev)})
    sizes = {f: os.path.getsize(os.path.join(out, f))
             for f in ("forward.pt2", "weights.pt", "meta.json")}
    return {"input": [n_channels, seq_len], "subjects": n_subjects,
            "export_s": export_s, "load_s": load_s, "rel_err": errs,
            "limit": EXPORT_RTOL, "card_vs_cpu_rel_err": cpu_err,
            "card_vs_cpu_limit": CARD_CPU_RTOL, "launches": launches,
            "restored_bit_identical": True, "file_bytes": sizes,
            "latency": rows}


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
                        "bn_stats": 0, "bn_affine": 0, "bn_bwd_stats": 0}
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
                        "bn_stats": 0, "bn_affine": 0, "bn_bwd_stats": 0}
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


def graphed(make_state):
    """``make_state`` whose step replays one ``GraphedStep`` of the step's
    body (under the step's mesh), captured at its first call: the route
    ``fit`` takes.  The step's ``graph`` is that ``GraphedStep``."""
    def make():
        model, state, step = make_state()
        graph = GraphedStep(step.body, state, mesh=step.mesh)

        def run(state, *batch, **kw):
            return state, graph(step.prepare(state, *batch, **kw))

        run.graph = graph
        return model, state, run
    return make


SPILL_ROUTES = ("device", "spill", "device_graph", "spill_graph")


def same_draw_runs(make_state, batches_device, batches_spill) -> dict:
    """SPILL_STEPS + 1 unfused steps on the device-resident batches and on
    the spilled ones (host gathers through ``prefetch_to_device``), each
    stepped eagerly and through one graph (``graphed``), the same draws and
    init, cuDNN deterministic: each graph route bit-identical to its eager
    route (losses and every state entry), one capture, one replay and the
    eager route's launches a step; the spilled routes against the
    device-resident ones within SPILL_RTOL (the host gather clamps an
    onset past T − padded_window(L) to T − L, the device gather to
    T − padded_window(L)). The wall time a step of each graph route, its
    first step (the capture) untimed, one synchronize at the end; the
    graph routes' capture s and every route's peak memory."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for kind in SPILL_ROUTES:
            make = graphed(make_state) if kind.endswith("graph") else make_state
            batches = batches_spill if kind.startswith("spill") else batches_device
            model, state, step = make()
            before, graphs = launch_counts(), graph_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = []
            for i, batch in enumerate(batches()):
                if i == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                state, m = step(state, *batch)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            after = launch_counts()
            out[kind] = {
                "entries": state_entries(state), "losses": [float(v) for v in losses],
                "ms": (time.perf_counter() - t0) * 1e3 / (len(losses) - 1)
                if kind.endswith("graph") else None,
                "launches": {k: after[k] - before[k] for k in after},
                "graphs": {k: v - graphs[k] for k, v in graph_counts().items()},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "capture_s": getattr(getattr(step, "graph", None),
                                     "capture_seconds", None)}
            del model, state, step
    finally:
        torch.backends.cudnn.deterministic = prev
    n = len(out["device"]["losses"])
    for kind in ("device_graph", "spill_graph"):
        g, e = out[kind], out[kind[:-6]]
        _, same = rel_diff(g["entries"], e["entries"])
        if not (same and g["losses"] == e["losses"]):
            raise AssertionError(f"spill check: {kind} not bit-identical to "
                                 f"its eager route: {g['losses']} / {e['losses']}")
        if g["launches"] != e["launches"]:
            raise AssertionError(f"spill check: {kind} launches {g['launches']}, "
                                 f"eager {e['launches']}")
        graph_replays(f"spill check {kind}", n, 0, got=g["graphs"])
    d, sp = out["device"], out["spill"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sp["losses"], d["losses"]))
    p_rel, same = rel_diff(sp["entries"], d["entries"])
    if len(sp["losses"]) != n or not (loss_rel <= SPILL_RTOL and p_rel <= SPILL_RTOL):
        raise AssertionError(f"spill vs device: losses {sp['losses']} / "
                             f"{d['losses']}, state {p_rel}")
    return {"steps": n, **{f"{k}_step_ms": out[k]["ms"] for k in SPILL_ROUTES[2:]},
            "capture_s": {k: out[k]["capture_s"] for k in SPILL_ROUTES[2:]},
            "peak_gb": {k: out[k]["peak_gb"] for k in SPILL_ROUTES},
            "graphs_bit_identical_to_eager": True,
            "spill_bit_identical_to_device": same and sp["losses"] == d["losses"],
            "losses": d["losses"], "loss_rel_err": loss_rel,
            "state_rel_err": p_rel, "limit": SPILL_RTOL,
            "launches_per_step": per_unit(out["spill_graph"]["launches"], n)}


def spill_cli(run, tcfg, work, name, expected, updates: int, pools: int) -> dict:
    """A train CLI with ``host_resident: true, prefetch: 2`` and the epoch
    traced: exact launches, its ``updates`` steps through one train graph
    and its ``pools`` test pools through one eval graph, and a trace
    holding the port's kernels in the train graph's replays and a
    host-to-device copy on a stream other than the one those replays ran
    on."""
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
    # one train replay an update, one eval replay a pool
    graph_replays(f"{name} spill CLI", updates, pools)
    if best.get("train_skipped") != 0.0 or not math.isfinite(best["train_loss"]):
        raise AssertionError(f"{name} spill CLI: {best}")
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as f:
        events = json.load(f)["traceEvents"]
    # the kernels of the train graph's replays: those launched by a
    # cudaGraphLaunch (its correlation id); the warm-up before the capture
    # ran the same kernels eagerly on a side stream
    replay_ids = {e.get("args", {}).get("correlation") for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "GraphLaunch" in str(e.get("name"))}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in replay_ids]
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
            "trace": {"events": len(events), "graph_launches": len(replay_ids),
                      "port_kernels_in_replays": ours,
                      "h2d_copies": len(copies_h2d), "h2d_off_compute": len(side),
                      "h2d_streams": streams(copies_h2d),
                      "compute_streams": sorted(compute)},
            "train_cli": {k: best[k] for k in ("train_loss", "train_skipped",
                                               "test_loss", "t_gather_ms",
                                               "t_step_ms")}}


def direct_quantiles(x2d, qs=(25.0, 50.0, 75.0)):
    """The kernel's launch called directly, past the registered op."""
    return qk._launch(x2d, tuple(qs))


def route_cost() -> dict:
    """What the registered op costs a call against a direct call of the
    same launch: the host time of one call on a (8, 24) block (the kernel
    a few µs; 400 calls, one synchronize), in blocks op, direct, direct, op
    after one untimed call of each."""
    routes = {"op": qk.robust_quantiles, "direct": direct_quantiles}
    tiny = torch.randn(8, 24, device="cuda")
    dispatch = {k: [] for k in routes}
    for fn in routes.values():
        fn(tiny)
    for name in ("op", "direct", "direct", "op"):
        fn = routes[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(400):
            fn(tiny)
        torch.cuda.synchronize()
        dispatch[name].append((time.perf_counter() - t0) * 1e6 / 400)
    return {"call_us": dispatch}


def busy_ms(spans) -> float:
    """Milliseconds covered by the union of (start µs, duration µs) spans."""
    total, end = 0.0, -math.inf
    for ts, dur in sorted(spans):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total / 1e3


def traced_steps(make_state, batches, path: str) -> dict:
    """The steps of ``batches()`` (its first untimed: a graph route's
    capture) under torch.profiler, the trace written to ``path``, split per
    step: wall time; the host thread that launches the kernels or the
    graph (the compute thread), its time inside operators and outside them
    (Python, waits); the card's busy time and operations (kernels, copies,
    memsets) and its idle share of the wall time."""
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
        if e.get("cat") == "cuda_runtime" and (
                "LaunchKernel" in str(e.get("name"))
                or "GraphLaunch" in str(e.get("name"))):
            launches[e["tid"]] = launches.get(e["tid"], 0) + 1
    compute = max(launches, key=launches.get, default=None)
    ops = busy_ms((e["ts"], e["dur"]) for e in events
                  if e.get("cat") == "cpu_op" and e["tid"] == compute)
    device = [(e["ts"], e["dur"]) for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    on_card = busy_ms(device)
    return {"step_ms": wall_ms / n, "compute_thread_ops_ms": ops / n,
            "compute_thread_other_ms": (wall_ms - ops) / n,
            "device_busy_ms": on_card / n, "device_ops_per_step": len(device) / n,
            "idle_share": 1.0 - on_card / wall_ms, "steps": n}


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
    (``host_batches()`` through ``prefetch_to_device``), each through one
    graph (``graphed``), with the spill producer's thread CPU and wall time
    per batch (the profiler traces the compute thread's operators only)."""
    make, spent = graphed(make_state), []
    out = {"device_graph": traced_steps(
        make, batches_device,
        os.path.join(work, f"split_{name}_device_graph.json"))}
    spill = out["spill_graph"] = traced_steps(
        make,
        lambda: prefetch_to_device(producer_timed(host_batches(), spent),
                                   size=2, device="cuda"),
        os.path.join(work, f"split_{name}_spill_graph.json"))
    spill["producer_cpu_ms"] = sum(c for c, _ in spent) * 1e3 / len(spent)
    spill["producer_wall_ms"] = sum(w for _, w in spent) * 1e3 / len(spent)
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
    pools = len(_test_pool_starts(len(test_pool), min(len(test_pool), BATCH),
                                  True))
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
    route = route_cost()
    pinned = bool(spilled["ds"].recordings.is_pinned())
    bytes_per_step = BATCH * (C * L + int(ds.y_stream.shape[1]) * L) * 4
    del train_pool, test_pool, ds, device_ds, spilled

    out = os.path.join(work, "spill_out")
    tcfg = compose(CONFIGS_DIR, "config", [
        f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
        f"batch_size={BATCH}", "epochs=1", f"updates={TRAIN_UPDATES}",
        "fuse_gather=false", "run_name=spill"])
    expected = dict(unfused_launches, window_gather=0)
    cli = spill_cli(train_speech.run, tcfg, work, "speech", expected,
                    TRAIN_UPDATES, pools)
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
    route = route_cost()
    pinned = bool(host.X.is_pinned())
    del host
    tcfg = Config(dict(to_dict(cfg), save_root=os.path.join(work, "spill_god"),
                       run_name="spill"))
    n_train = int(round(len(god_ds) * 5 / 6))
    pools = len(_test_pool_starts(len(god_ds) - n_train,
                                  min(len(god_ds) - n_train, int(cfg.test_size)),
                                  bool(cfg.get("test_sweep", True))))
    cli = spill_cli(train_god.run, tcfg, work, "god", dict(god_launches),
                    n_train // BATCH, pools)
    emit({"phase": "spill_god", **check, "pinned": pinned, "split": split,
          "quantile_route": route, **cli})
    return cli["launches"]


# --- data parallelism, the Kamitani baseline, the feature galleries --------

DP_STEPS = 6          # same-draw steps of each form (the first untimed)
DP_RTOL = 1e-5        # DP at world 1 vs one device: first-step loss, grad norm
DP_TRAJ_RTOL = 1e-4   # every later step's loss and grad norm
KAMITANI_ITERS = 200
KAMITANI_RTOL = 1e-4  # card vs CPU predictions: f32 batched SVDs, two libraries
GALLERY_SHAPES = ((375, 500), (500, 375), (333, 500), (400, 400), (281, 500))
GALLERY_CHECK = 8
GALLERY_DISTINCT = 50


def dp_group(work: str, name: str):
    """A one-rank NCCL group through the ``distributed:`` block's route,
    and ``setup_data_parallel``'s mesh, shard_fn and replicate_fn on it."""
    block = {"coordinator_address": "file://" + os.path.join(work, name + "_store"),
             "num_processes": 1, "process_id": 0, "timeout_s": 300}
    dev = maybe_distributed_init(Config({"distributed": block}), "cuda")
    mesh, shard_fn, replicate_fn = setup_data_parallel(Config({}), dev)
    if mesh is None or torch.distributed.get_backend() != "nccl":
        raise AssertionError("no NCCL data-parallel mesh")
    return mesh, shard_fn, replicate_fn


def dp_launches() -> dict:
    return {**all_launches(), "bn_bwd_sums_only": bk.sums_only_launches,
            "bn_bwd_dx": bk.dx_launches}


# the entries whose gradient is rounding noise by construction: a conv
# bias before a BN (the BN takes its mean out), that BN's running mean, and
# the constant column of the spatial attention's Fourier basis (its
# softmax drops it)
NOISE_ONLY = re.compile(r"conv\d+\.(conv[01]\.bias|bn[01]\.mean)$")
NOISE_COLUMN = "spatial_attention.z_re"
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
LOOSE_WHOLE = 0.99  # a tensor this loose counts as loose as a whole
GRAD_RTOL = 1e-4  # the first step's gradients, of each tensor's max |g|


class GradRecorder(Adam):
    """The optimizer a run was given, keeping a copy of the gradients of
    its first DP_STEPS steps (one the loss does not reach as zeros)."""

    def __init__(self, opt: Adam):
        super().__init__(opt.schedule)
        self.grads = []

    def update(self, params, grads, state, ok):
        if len(self.grads) < DP_STEPS:
            self.grads.append({k: torch.zeros_like(p) if grads.get(k) is None
                               else grads[k].detach().clone()
                               for k, p in params.items()})
        super().update(params, grads, state, ok)


def state_check(got: dict, want: dict, grads_got: list, grads_want: list,
                lr: float) -> dict:
    """Two runs from one state on the same draws, ``want`` the reference.

    The first step's gradients, both taken at the same state, agree
    within GRAD_RTOL of their tensor's max |g| (every entry but the name
    rule's below, whose gradient is rounding noise of zero).  Every
    state entry ends within STATE_RTOL·|want| + STATE_ATOL, except one
    whose gradient is at rounding level, which ends within the walk
    2·n·lr: Adam's step lr·m̂/(√v̂ + ε) turns a gradient that the runs'
    rounding moves by a share r into a move of about lr·r, so an entry
    is at rounding level when at some step the runs' difference in its
    gradient is more than STATE_ATOL/(n·lr) of the reference's (the
    gradient rule), or when it is one of NOISE_ONLY's tensors or
    NOISE_COLUMN's column 0 (zero in exact arithmetic: the name rule).
    Returns the entries of each rule, the shares of their bounds, and the
    tensors off their bound (worst share, name, flat index, entries off,
    got, want; empty when all hold)."""
    def by_name(k, t):
        named = torch.zeros_like(t, dtype=torch.bool)
        if NOISE_ONLY.search(k):
            named[...] = True
        elif k.endswith(NOISE_COLUMN):
            named[:, 0] = True
        return named

    walk = 2 * len(grads_want) * lr
    amp = len(grads_want) * lr / STATE_ATOL
    first, first_at = 0.0, None
    for k, w in grads_want[0].items():
        keep = ~by_name(k, w)
        if not bool(keep.any()):
            continue
        d = float((grads_got[0][k] - w).abs()[keep].max())
        scale = GRAD_RTOL * float(w.abs()[keep].max())
        share = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
        if first_at is None or share > first:
            first, first_at = share, k
    n_named = n_grad = strict_share = loose_share = max_abs = 0.0
    bad, loose = [], []
    for k, w in want.items():
        w, g = w.float(), got[k].float()
        d = (g - w).abs()
        max_abs = max(max_abs, float(d.max()))
        named = by_name(k, d)
        noise = named.clone()
        if k in grads_want[0]:
            at_first = None
            for gw, gg in zip(grads_want, grads_got):
                noise |= gw[k].abs() < amp * (gg[k] - gw[k]).abs()
                if at_first is None:
                    at_first = noise & ~named
            by_grad = noise & ~named
            if bool(by_grad.any()):
                loose.append(loose_entries(k, by_grad, at_first, grads_want,
                                           grads_got))
        n_named += int(named.sum())
        n_grad += int((noise & ~named).sum())
        share = d / torch.where(noise, walk, STATE_RTOL * w.abs() + STATE_ATOL)
        if bool(noise.any()):
            loose_share = max(loose_share, float(share[noise].max()))
        if not bool(noise.all()):
            strict_share = max(strict_share, float(share[~noise].max()))
        i = int(share.argmax())
        if float(share.flatten()[i]) > 1.0:
            bad.append((float(share.flatten()[i]), k, i, int((share > 1).sum()),
                        float(g.flatten()[i]), float(w.flatten()[i])))
    return {"entries": sum(v.numel() for v in want.values()),
            "first_step_grad_share": first, "first_step_grad_worst": first_at,
            "loose_by_name": int(n_named), "loose_by_gradient": int(n_grad),
            "params_max_abs_err": max_abs,
            "strict_max_share": strict_share, "loose_max_share": loose_share,
            "off_bound": sorted(bad, reverse=True)[:8],
            "loose_by_tensor": sorted(loose, key=lambda r: -r["loose"]),
            "whole_tensors_loose": [r["tensor"] for r in loose
                                    if r["share"] >= LOOSE_WHOLE]}


def loose_entries(k: str, sel: torch.Tensor, at_first: torch.Tensor,
                  grads_want: list, grads_got: list) -> dict:
    """Tensor ``k``'s entries that the gradient rule lets loose (``sel``):
    their count and share of the tensor, how many were loose at the first
    step already (both runs at one state: the computation's own rounding),
    and their |g| at the first step (max, median) beside the tensor's, with
    the runs' largest relative difference in g over the steps, |Δg|/|g|:
    Adam turns that share into a step difference of about lr·|Δg|/|g|, so
    entries whose |g| sits far below the tensor's typical one amplify
    rounding; loose entries with the tensor's typical |g| do not."""
    g0 = grads_want[0][k].float().abs()
    rel = torch.zeros_like(g0)
    for gw, gg in zip(grads_want, grads_got):
        rel = torch.maximum(rel, (gg[k] - gw[k]).float().abs()
                            / gw[k].float().abs().clamp_min(1e-30))
    n = int(sel.sum())
    return {"tensor": k, "loose": n, "share": n / sel.numel(),
            "loose_at_first_step": int(at_first.sum()),
            "loose_max_abs_g": float(g0[sel].max()),
            "loose_median_abs_g": float(g0[sel].median()),
            "tensor_max_abs_g": float(g0.max()),
            "tensor_median_abs_g": float(g0.median()),
            "loose_median_rel_dg": float(rel[sel].median()),
            "other_median_rel_dg": (float(rel[~sel].median())
                                    if bool((~sel).any()) else None)}


def dp_vs_single(run_single, run_dp, lr: float) -> dict:
    """DP_STEPS same-draw steps of each form, cuDNN deterministic, single
    first, each run with a GradRecorder.  What holds (the two differ by
    the order of f32 sums): the first step's loss and global gradient norm
    within DP_RTOL relative, every later step's within DP_TRAJ_RTOL, and
    the gradients and the state by ``state_check``.  Returns the check
    and the DP run's launches."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model_a, hist_a, grads_a = run_single()
        reset_all_launches()
        model_b, hist_b, grads_b = run_dp()
        launches = dp_launches()
    finally:
        torch.backends.cudnn.deterministic = prev
    rel = {k: [abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(hist_a, hist_b)]
           for k in ("loss", "grad_norm")}
    state = state_check(model_b.state_dict(), model_a.state_dict(),
                        grads_b, grads_a, lr)
    del grads_a, grads_b
    check = {"loss_rel_err": rel["loss"], "grad_norm_rel_err": rel["grad_norm"],
             "state": state,
             "limits": {"first_step": DP_RTOL, "later_steps": DP_TRAJ_RTOL,
                        "first_step_grads": GRAD_RTOL,
                        "state_rtol": STATE_RTOL, "state_atol": STATE_ATOL,
                        "state_loose_abs": 2 * DP_STEPS * lr},
             "losses_single": [h["loss"] for h in hist_a],
             "losses_dp": [h["loss"] for h in hist_b]}
    ok = (all(r[0] <= DP_RTOL and max(r) <= DP_TRAJ_RTOL for r in rel.values())
          and state["first_step_grad_share"] <= 1.0 and not state["off_bound"]
          and all(math.isfinite(h["loss"]) for h in hist_a + hist_b))
    if not ok:
        raise AssertionError(f"DP vs one device: {check}")
    return check, launches


def run_steps(step_fn, n: int) -> list:
    """``n`` steps: their metrics."""
    hist = []
    for u in range(n):
        m = step_fn(u)
        hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "skipped")})
        if hist[-1]["skipped"] != 0.0:
            raise AssertionError(f"step {u} skipped: {m}")
    return hist


def profile_steps(step_fn, n: int = 3) -> dict:
    """``n`` steps under torch.profiler (after one untimed): wall ms a step,
    the card's kernel time a step (device events only), the host's
    collectives a step (``nccl:*`` / ``gloo:*`` operations) and the host
    time inside the ``c10d::`` collective operations, the NCCL kernels
    and their device time a step (a one-rank group may run its
    collectives as copies, with no NCCL kernel: then 0), and the device
    operations a step."""
    from torch.profiler import ProfilerActivity, profile

    step_fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for u in range(n):
            step_fn(u)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host, kernels, nccl_us, device_us, c10d_us, ops = {}, 0, 0.0, 0.0, 0.0, 0
    for ev in prof.key_averages():
        name = ev.key.lower()
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dt = float(getattr(ev, "self_device_time_total", 0.0)
                       or getattr(ev, "self_cuda_time_total", 0.0))
            device_us += dt
            ops += ev.count
            if "nccl" in name:
                kernels += ev.count
                nccl_us += dt
        elif name.startswith(("nccl:", "gloo:")):
            host[ev.key] = ev.count / n
        elif name.startswith("c10d::"):
            c10d_us += float(ev.cpu_time_total)
    return {"wall_ms_per_step": wall_ms / n,
            "device_kernel_ms_per_step": device_us / n / 1e3,
            "host_ops_per_step": host,
            "host_collectives_per_step": sum(host.values()),
            "host_c10d_ms_per_step": c10d_us / n / 1e3,
            "nccl_kernels_per_step": kernels / n,
            "nccl_device_us_per_step": nccl_us / n,
            "device_ops_per_step": ops / n}


DIST_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_gather_into_tensor", "reduce_scatter_tensor")


def dist_calls(fn, bodies: int = 1) -> dict:
    """The collectives ``fn()`` issues through ``torch.distributed`` (the
    mesh's and autograd's alike), by name, per one of its ``bodies`` runs
    of a step body: counted by wrapping the module's functions, so that a
    graph's capture is counted without a profiler inside it."""
    import torch.distributed as dist

    counts = dict.fromkeys(DIST_COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in DIST_COLLECTIVES}

    def counting(name):
        def call(*a, **k):
            counts[name] += 1
            return real[name](*a, **k)
        return call

    for name in DIST_COLLECTIVES:
        setattr(dist, name, counting(name))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    by_name = {k: n / bodies for k, n in counts.items() if n}
    return {"per_body": sum(by_name.values()), "by_name": by_name}


def dp_graph_check(name: str, cfg, make, smi: str) -> dict:
    """The data-parallel step's graph route against its eager route
    (``graph_path``: DP_STEPS same draws from one init, cuDNN
    deterministic, launches a step equal, one capture, a replay a step;
    the graph route profiled), bit-identical; then the collectives of each
    route on a new state: the eager step's a step (``dist_calls``), the
    graph's recorded in its capture (``dist_calls`` over the warm-up and
    the capture) and a replay's (none from the host; its NCCL kernels and
    ``c10d::`` host ms, ``profile_steps``)."""
    row = graph_path(name, cfg, make, DP_STEPS, 1, smi)
    if not (row["state_bit_identical"] and row["metrics_bit_identical"]):
        raise AssertionError(f"{name}: the DP graph route is not bit-identical "
                             f"to the eager DP route ({row['state_rel_err']}, "
                             f"{row['metrics_rel_err']})")
    _, eager, _, _ = make()
    calls = {"eager": dist_calls(lambda: eager(0))}
    del eager
    _, _, graphed_fn, graph_of = make()
    calls["captured"] = dist_calls(lambda: graphed_fn(0), tg.WARMUP + 1)
    calls["replay"] = dist_calls(lambda: graphed_fn(1))
    graph_prof = profile_steps(graphed_fn)
    capture_s = graph_of().capture_seconds
    del graphed_fn, graph_of
    if not (calls["captured"] == calls["eager"] and calls["eager"]["per_body"] > 0
            and calls["replay"]["per_body"] == 0
            and graph_prof["host_collectives_per_step"] == 0):
        raise AssertionError(f"{name} collectives: calls {calls}, "
                             f"replay {graph_prof}")
    return {"graph_vs_eager": {k: row[k] for k in (
                "state_bit_identical", "metrics_bit_identical",
                "graph_ms_median", "capture_s", "launches_per_step", "replays",
                "peak_gb", "profile")},
            "collectives": {"calls": calls, "graph": graph_prof,
                            "capture_s": capture_s}}


def bn_split_rows(mesh, B: int, T: int, flush) -> dict:
    """The synced BN backward's split route at (B, D2, T), f32 and bf16:
    the sums alone, the all-reduce, ``bn_bwd_dx`` from the global sums —
    its dx bit-identical across two launches and to the fused ``bn_bwd``'s
    (one rank: the same sums), within ``bn_bwd_check``'s bound of it, and
    against its plain version on the same sums (a few f32 ulps of the
    terms, max abs error printed); timed with its bound (its single launches
    in turns with the library's), its host time a call beside the
    library's."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(T)
        x, g = bn_inputs(gen, B, D2, T, dtype)
        M = B * T
        s, ss = bk.bn_stats(x)
        mean = s / M
        invstd = torch.rsqrt(ss / M - mean * mean + 1e-5)
        scale = torch.rand(D2, device="cuda", generator=gen) + 0.5
        sg, sgx = bk.bn_bwd_stats(g, x, mean, invstd)
        sums = mesh.all_reduce_(torch.stack([sg, sgx]))
        dx = bk.bn_bwd_dx(g, x, scale, mean, invstd, sums, M)
        again = bk.bn_bwd_dx(g, x, scale, mean, invstd, sums, M)
        fused = bk.bn_bwd(g, x, scale, mean, invstd)
        plain = bk.bn_bwd_dx_plain(g, x, scale, mean, invstd, sums, M)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        # one rank: the global sums are the fused kernel's, and dx_of and
        # dx_coef are one code, so the two dx agree bit for bit
        if not (torch.equal(dx.view(bits), again.view(bits))
                and torch.equal(dx.view(bits), fused[0].view(bits))):
            raise AssertionError(f"bn_bwd_dx {dtype} {tuple(x.shape)}: not "
                                 "bit-identical across two launches and to "
                                 "the fused bn_bwd's dx")
        vs_fused = bn_bwd_check(g, x, scale, mean, invstd, (dx, sg, sgx), fused,
                                f"split BN backward {dtype}")
        # the plain version on the card divides by M as a multiply by 1/M
        # (PyTorch's division by a scalar), the kernel divides: a few f32
        # ulps of the terms' magnitude, plus one bf16 ulp in bf16
        d = (dx.float() - plain.float()).abs()
        err = float(d.max())
        xhat = (x.float() - mean[:, None]) * invstd[:, None]
        tol = 4 * 2.0**-23 * (scale * invstd).abs()[:, None] * (
            g.float().abs() + (sums[0].abs() / M)[:, None]
            + xhat.abs() * (sums[1].abs() / M)[:, None])
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(plain)
        if not bool((d <= tol).all()):
            raise AssertionError(f"bn_bwd_dx {dtype}: off its plain version "
                                 f"by {err} ({float((d / tol).max())} of the bound)")
        nbytes = 3 * x.numel() * x.element_size() + 7 * D2 * 4
        bound_ms, bound_by = bound(nbytes, 10 * x.numel())
        run = lambda xx: bk.bn_bwd_dx(g, xx, scale, mean, invstd, sums, M)
        # the library's dx from given sums: SyncBatchNorm's backward call,
        # which takes Σg·(x − mean) = Σg·x̂ / invstd and the ranks' counts
        sum_dy_xmu = sums[1] / invstd
        count = torch.tensor([M], dtype=torch.int32, device="cuda")
        lib = lambda: torch.batch_norm_backward_elemt(
            g, x, mean, invstd, scale, sums[0], sum_dy_xmu, count)
        lib_diff = float((lib().float() - dx.float()).abs().max())
        kernel_ms, library_ms = time_ms_turns([lambda: run(x), lib], flush)
        rows[str(dtype)] = {
            "shape": [B, D2, T], "vs_fused_bn_bwd": vs_fused,
            "bit_identical_to_fused_dx": True, "max_abs_err": err,
            "tolerance": "4 f32 ulps of |scale·invstd|·(|g| + |Σg|/M + "
                         "|x̂|·|Σg·x̂|/M), + 1 bf16 ulp in bf16",
            "kernel_ms": kernel_ms,
            "run_ms": run_ms([lambda xx=xx: run(xx)
                              for xx in copies(x, 3 * x.numel() * x.element_size())]),
            "host_us": host_us(lambda: run(x)),
            "plain_ms": time_ms(lambda: bk.bn_bwd_dx_plain(
                g, x, scale, mean, invstd, sums, M), flush),
            "library_ms": library_ms, "library_host_us": host_us(lib),
            "library_max_abs_diff": lib_diff,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "parent_run_us": PARENT_RUN_US.get(("bn_bwd_dx", (B, D2, T),
                                                str(dtype)))}
    return rows


def phase_dp_speech(cfg, ds, tr_idx, seed, work, smi: str) -> dict:
    """Data parallelism on the speech path at full width: DP_STEPS fused
    steps through ``setup_data_parallel``'s one-rank NCCL mesh (session-
    sharded gather, collate, synced BN by the split route, sharded CLIP
    loss, the flat gradient all-reduce) against the fused single-device
    step on the same draws; the DP step's graph route against its eager route (``dp_graph_check``);
    the split BN backward against the fused one; then the train CLI for
    one epoch with a ``distributed:`` block of one process (a train replay
    an update, an eval replay a pool), and the same with
    ``use_scan_epochs`` on the sentence split (``fit_scan``: the DP epoch
    through its graph).  Returns the launches of the DP steps and of the
    two CLIs."""
    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    loss_cfg = dataclasses.replace(train_speech.loss_config(cfg), grad_norms=True)
    collate = evaluate_speech.collate_config(cfg)
    pool = evaluate_speech.SpeechPool(ds, tr_idx, seed=seed)
    rng = np.random.RandomState(seed + 9)
    idx = [pool.segment_ids(rng.randint(0, len(pool), BATCH)) for _ in range(DP_STEPS)]
    # world size 1: the shard is every session, a local draw a global one
    sess = torch.randint(0, ds.num_sessions, (DP_STEPS, BATCH),
                         generator=torch.Generator().manual_seed(seed + 10))
    centres = torch.randint(C, (DP_STEPS,),
                            generator=torch.Generator().manual_seed(seed + 11))
    def fresh():
        model = get_model(cfg, loc, device=dev, seed=seed,
                          num_channels=int(ds.recordings.shape[2]))
        opt = GradRecorder(make_optimizer(cfg, DP_STEPS))
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    mesh, _, replicate_fn = dp_group(work, "dp_speech")
    try:
        def steps(mesh_or_none):
            def run():
                model, opt, state = fresh()
                if mesh_or_none is not None:
                    state = replicate_fn(state)
                fused = make_fused_speech_step(model, opt, loss_cfg, collate, ds,
                                               mesh=mesh_or_none)
                box = [state]

                def one(u):
                    box[0], m = fused(box[0], idx[u], sess_ids=sess[u],
                                      centre=int(centres[u]))
                    return m
                return model, run_steps(one, DP_STEPS), opt.grads
            return run

        single, dp = steps(None), steps(mesh)
        check, launches = dp_vs_single(single, dp, float(cfg.lr))
        expected = {"window_gather": 2 * DP_STEPS, "robust_quantiles": DP_STEPS,
                    "bn_stats": BN_PER_STEP * DP_STEPS,
                    "bn_affine": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_stats": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_sums_only": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_dx": BN_PER_STEP * DP_STEPS}
        if launches != expected:
            raise AssertionError(f"DP speech steps launches {launches}, "
                                 f"expected {expected}")

        # the DP step's graph route (what ``fit`` runs) against its eager
        # route on the same draws
        def make_dp():
            model = get_model(cfg, loc, device=dev, seed=seed,
                              num_channels=int(ds.recordings.shape[2]))
            opt = make_optimizer(cfg, DP_STEPS)
            state = replicate_fn(create_train_state(
                model, opt, float(cfg.init_temperature), seed))
            fused = make_fused_speech_step(model, opt, loss_cfg, collate, ds,
                                           mesh=mesh)
            graph = GraphedStep(fused.body, state, mesh=mesh)

            def args(i):
                u = i % DP_STEPS
                return (idx[u],), {"sess_ids": sess[u], "centre": int(centres[u])}

            def eager(i):
                a, kw = args(i)
                return fused(state, *a, **kw)[1]

            def graphed_fn(i):
                a, kw = args(i)
                return graph(fused.prepare(state, *a, **kw))
            return state, eager, graphed_fn, lambda: graph

        dp_graph = dp_graph_check("dp_speech_f32_b64", cfg, make_dp, smi)
        split = bn_split_rows(mesh, BATCH, 360, flush)
    finally:
        finish_distributed()
    del flush

    # the main path: the train CLI with a distributed: block of one
    # process, per step (``fit``) and the whole-epoch form (``fit_scan``
    # on the sentence split)
    clis = {}
    for form, updates, extra in (
            ("fit", TRAIN_UPDATES, []),
            ("fit_scan", SCAN_UPDATES, ["split_mode=sentence",
                                        "use_scan_epochs=true"])):
        out = os.path.join(work, f"dp_out_{form}")
        tcfg = compose(CONFIGS_DIR, "config", [
            f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
            f"batch_size={BATCH}", "epochs=1", f"updates={updates}",
            "run_name=dp", *extra,
            "+distributed.coordinator_address=file://"
            + os.path.join(work, f"dp_cli_store_{form}"),
            "+distributed.num_processes=1", "+distributed.process_id=0"])
        n_test = (len(ds) - len(tr_idx) if form == "fit" else
                  len(evaluate_speech.load_gwilliams_splits(
                      Config(to_dict(tcfg)), seed, "cpu")[1]))
        pools = len(_test_pool_starts(n_test, min(n_test, BATCH),
                                      bool(tcfg.get("test_sweep", True))))
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            best = train_speech.run(tcfg, device="cuda")
        finally:
            finish_distributed()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        cli = dp_launches()
        # the data-parallel route replays its train graph once an update
        # and its eval graph once a pool, one capture each
        replays = graph_replays(f"DP speech CLI ({form})", updates, pools)
        want = {"window_gather": 2 * (updates + pools),
                "robust_quantiles": updates + pools,
                "bn_stats": BN_PER_STEP * updates,
                "bn_affine": BN_PER_STEP * updates,
                "bn_bwd_stats": BN_PER_STEP * updates,
                "bn_bwd_sums_only": BN_PER_STEP * updates,
                "bn_bwd_dx": BN_PER_STEP * updates}
        if cli != want:
            raise AssertionError(f"DP train CLI ({form}) launches {cli}, "
                                 f"expected {want}")
        with open(os.path.join(out, "runs", "dp", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) != 1 or rows[0]["train_skipped"] != 0.0 \
                or not math.isfinite(rows[0]["train_loss"]):
            raise AssertionError(f"DP train CLI ({form}): {rows}")
        clis[form] = {"train_cli_s": run_s, "launches": cli, "test_pools": pools,
                      "graphs": replays,
                      "train_cli": {k: best[k] for k in (
                          "train_loss", "train_skipped", "test_loss",
                          "test_top10")}}
    emit({"phase": "data_parallel", "workload": "speech", "world_size": 1,
          "backend": "nccl", "nccl": list(torch.cuda.nccl.version()),
          "device": smi, "batch_size": BATCH, "steps": DP_STEPS, **check,
          "launches": launches, "graph": dp_graph,
          "bn_split_backward": split, "train_clis": clis})
    return {"steps": launches, "cli": clis["fit"]["launches"],
            "scan_cli": clis["fit_scan"]["launches"], "split": split}


def phase_dp_god(cfg, ds, seed, work, smi: str) -> dict:
    """The GOD per-step path under the one-rank NCCL mesh
    (``configs/config_GOD.yaml``, B = 64): DP_STEPS steps of
    ``make_train_step(mesh=)`` on ``shard_fn``'s rows against the
    single-device step on the same batches, the step's graph route against its eager route (``dp_graph_check``), the
    split BN backward at the GOD shape.  Returns the DP steps' launches."""
    dev = torch.device("cuda")
    cfg.num_subjects = ds.num_subjects
    loc = ch_locations_2d(cfg, roi(cfg))
    loss_cfg = dataclasses.replace(train_god._loss_config(cfg), grad_norms=True)
    collate = evaluate_speech.collate_config(cfg)
    rng = np.random.RandomState(seed + 12)
    batches = [ds.gather(rng.randint(0, len(ds), BATCH))[:3] for _ in range(DP_STEPS)]
    centres = torch.randint(len(loc), (DP_STEPS,),
                            generator=torch.Generator().manual_seed(seed + 13))

    def fresh():
        model = get_model(cfg, loc, device=dev, seed=seed)
        opt = GradRecorder(make_optimizer(cfg, int(cfg.updates)))
        return model, opt, create_train_state(model, opt,
                                              float(cfg.init_temperature), seed)

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    mesh, shard_fn, replicate_fn = dp_group(work, "dp_god")
    try:
        def steps(mesh_or_none):
            def run():
                model, opt, state = fresh()
                if mesh_or_none is not None:
                    state = replicate_fn(state)
                step = make_train_step(model, opt, loss_cfg, collate,
                                       mesh=mesh_or_none)
                box = [state]

                def one(u):
                    b = batches[u] if mesh_or_none is None else shard_fn(batches[u])
                    box[0], m = step(box[0], *b, centre=int(centres[u]))
                    return m
                return model, run_steps(one, DP_STEPS), opt.grads
            return run

        single, dp = steps(None), steps(mesh)
        check, launches = dp_vs_single(single, dp, float(cfg.lr))
        expected = {"window_gather": 0, "robust_quantiles": DP_STEPS,
                    "bn_stats": BN_PER_STEP * DP_STEPS,
                    "bn_affine": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_stats": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_sums_only": BN_PER_STEP * DP_STEPS,
                    "bn_bwd_dx": BN_PER_STEP * DP_STEPS}
        if launches != expected:
            raise AssertionError(f"DP GOD steps launches {launches}, "
                                 f"expected {expected}")

        def make_dp():
            model = get_model(cfg, loc, device=dev, seed=seed)
            opt = make_optimizer(cfg, int(cfg.updates))
            state = replicate_fn(create_train_state(
                model, opt, float(cfg.init_temperature), seed))
            step = make_train_step(model, opt, loss_cfg, collate, mesh=mesh)
            graph = GraphedStep(step.body, state, mesh=mesh)

            def args(i):
                u = i % DP_STEPS
                return shard_fn(batches[u]), {"centre": int(centres[u])}

            def eager(i):
                a, kw = args(i)
                return step(state, *a, **kw)[1]

            def graphed_fn(i):
                a, kw = args(i)
                return graph(step.prepare(state, *a, **kw))
            return state, eager, graphed_fn, lambda: graph

        dp_graph = dp_graph_check("dp_god_b64", cfg, make_dp, smi)
        split = bn_split_rows(mesh, BATCH, int(ds.X.shape[2]), flush)
    finally:
        finish_distributed()
    emit({"phase": "data_parallel", "workload": "god", "world_size": 1,
          "backend": "nccl", "nccl": list(torch.cuda.nccl.version()),
          "device": smi, "batch_size": BATCH, "steps": DP_STEPS, **check,
          "launches": launches, "graph": dp_graph,
          "bn_split_backward": split})
    return {"steps": launches, "split": split}


def phase_kamitani(god_cfg, work) -> dict:
    """The Kamitani baseline on the GOD set above: the CLI's ``run`` on the
    card (SCP time-mean, 512 units × 22 channels, KAMITANI_ITERS
    iterations, the identification rate), then ``feature_prediction`` on
    the same inputs on the card and on the CPU: per-category rates equal,
    predictions within KAMITANI_RTOL·max|pred|, a pruning-mask bit that
    differs only where its weight is within KAMITANI_RTOL of the unit's
    max |W|, both timed.
    Returns the CLI's launches."""
    from meg_decoding_tpu_torch.cli import kamitani_regression
    from meg_decoding_tpu_torch.kamitani.pipeline import (
        feature_prediction,
        get_averaged_feature,
        pairwise_identification_rate,
    )

    cfg = Config(dict(to_dict(god_cfg), save_root=os.path.join(work, "kamitani")))
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, cat = kamitani_regression.run(cfg, ch_ratios=1.0, n_iter=KAMITANI_ITERS,
                                       device="cuda")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = all_launches()
    train = build_god_dataset(cfg, "train", device="cuda")
    test = build_god_dataset(cfg, "val", device="cuda")
    args = (train.X.mean(-1).cpu().numpy(), train.Y.cpu().numpy(),
            test.X.mean(-1).cpu().numpy(), test.Y.cpu().numpy())
    labels = test.labels.cpu().numpy()
    out = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, true, fit = feature_prediction(*args, n_voxel=args[0].shape[1],
                                             n_iter=KAMITANI_ITERS, device=dev,
                                             return_fit=True)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        avg = get_averaged_feature(pred, true, labels)
        out[dev] = (pred, fit, pairwise_identification_rate(avg[0], avg[1],
                                                            device=dev), s)
    (pc, fc, rc, sc), (ph, fh, rh, sh) = out["cuda"], out["cpu"]
    pred_err = float(np.abs(pc - ph).max() / np.abs(ph).max())
    # a mask bit may flip between the two: a feature whose relative alpha
    # crosses the 1e-10 threshold one iteration apart; its weight is then
    # negligible on the side that keeps it (held: ≤ KAMITANI_RTOL of the
    # unit's max |W|)
    flips = np.argwhere(fc[3] != fh[3])
    flip_w = max((max(abs(fc[0][u, 0, f]), abs(fh[0][u, 0, f]))
                  / np.abs(fh[0][u]).max() for u, f in flips), default=0.0)
    check = {"units": int(args[1].shape[1]), "channels": int(args[0].shape[1]),
             "train_trials": int(args[0].shape[0]),
             "test_trials": int(args[2].shape[0]),
             "mask_bits": int(fc[3].size), "mask_bits_differing": len(flips),
             "differing_bits_max_rel_weight": float(flip_w),
             "kept_features_card": int(fc[3].sum()),
             "kept_features_cpu": int(fh[3].sum()),
             "pred_max_rel_err": pred_err, "limit": KAMITANI_RTOL,
             "rates_equal": bool((rc == rh).all()),
             "acc_card": float(rc.mean()), "acc_cpu": float(rh.mean())}
    if not (flip_w <= KAMITANI_RTOL and check["rates_equal"]
            and pred_err <= KAMITANI_RTOL and abs(acc - float(rc.mean())) < 1e-12):
        raise AssertionError(f"Kamitani card vs CPU: {check}, CLI acc {acc}")
    emit({"phase": "kamitani", "cli_s": cli_s, "cli_acc": acc,
          "card_fit_s": sc, "cpu_fit_s": sh, **check, "launches": launches,
          "categories": len(cat)})
    return launches


def phase_galleries(seed: int, work: str) -> None:
    """The gallery CLI on 1,250 PNGs of mixed GOD-like sizes written here
    (``utils/png.py``) with random-weight ViT-B/32 on the card: seconds and
    images/s; then GALLERY_CHECK of them card against CPU (the uint8
    images ≤ 1 apart on ≤ 0.1 % of pixels; the features ≤ FEATURE_RTOL)."""
    from meg_decoding_tpu_torch.cli import create_image_features as gallery
    from meg_decoding_tpu_torch.features import clip_features
    from meg_decoding_tpu_torch.features.clip_model import CLIPImageEncoder
    from meg_decoding_tpu_torch.utils.png import write_png

    img_dir = os.path.join(work, "images")
    os.makedirs(img_dir)
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    # GALLERY_DISTINCT images written (each shape, both filters), the rest
    # hard links to them: the CLI reads and decodes every file
    for i in range(GOD_IMAGES):
        path = os.path.join(img_dir, f"img{i:05d}.png")
        if i >= GALLERY_DISTINCT:
            os.link(os.path.join(img_dir, f"img{i % GALLERY_DISTINCT:05d}.png"), path)
            continue
        H, W = GALLERY_SHAPES[i % len(GALLERY_SHAPES)]
        yy, xx = np.mgrid[0:H, 0:W]
        base = np.stack([(yy * rng.randint(1, 4) + xx * rng.randint(1, 4)
                          + rng.randint(0, 256)) % 256 for _ in range(3)], -1)
        im = (base + rng.randint(0, 8, (H, W, 3))).astype(np.uint8)
        write_png(path, im, filter_type=2 * (i % 2))
    write_s = time.perf_counter() - t0
    # where the CLI's time goes, on the first GALLERY_DISTINCT files:
    # decoding on the host, then the resize on the card
    names = sorted(os.listdir(img_dir))[:GALLERY_DISTINCT]
    t0 = time.perf_counter()
    decoded = [gallery._read(os.path.join(img_dir, n)) for n in names]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im in decoded:
        gallery.resize_shortest_crop(im, "cuda")
    torch.cuda.synchronize()
    resize_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    out = os.path.join(work, "gallery.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = gallery.main([img_dir, out, "random", "--device", "cuda",
                          "--seed", str(seed)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    if feats.shape != (GOD_IMAGES, 512) or not np.isfinite(feats).all():
        raise AssertionError(f"gallery {feats.shape}")
    # card against CPU on a few: the images, then one model's features
    few = os.path.join(work, "images_few")
    os.makedirs(few)
    for name in sorted(os.listdir(img_dir))[:GALLERY_CHECK]:
        shutil.copy(os.path.join(img_dir, name), few)
    card = gallery.load_image_dir(few, "cuda")
    cpu = gallery.load_image_dir(few, "cpu")
    diff = (card.cpu().to(torch.int16) - cpu.to(torch.int16)).abs()
    model = clip_features.load_clip(backend="random", device="cuda", seed=seed)
    host = CLIPImageEncoder(model.config)
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    f_card = clip_features.encode_images(model, clip_features.preprocess_images(
        card, "cuda"))
    f_cpu = clip_features.encode_images(host.eval(), clip_features.preprocess_images(
        cpu, "cpu"))
    check = {"images": GALLERY_CHECK, "pixel_max_diff": int(diff.max()),
             "pixels_differing": float((diff > 0).float().mean()),
             "features_max_rel_err": max_rel(f_card, f_cpu),
             "cli_rows_max_rel_err": max_rel(torch.from_numpy(feats[:GALLERY_CHECK]),
                                             f_card.cpu()),
             "limits": {"pixel_max_diff": 1, "pixels_differing": 1e-3,
                        "features": FEATURE_RTOL}}
    if not (check["pixel_max_diff"] <= 1 and check["pixels_differing"] <= 1e-3
            and check["features_max_rel_err"] <= FEATURE_RTOL
            and check["cli_rows_max_rel_err"] <= FEATURE_RTOL):
        raise AssertionError(f"galleries card vs CPU: {check}")
    emit({"phase": "galleries", "images": GOD_IMAGES,
          "distinct_images": GALLERY_DISTINCT,
          "shapes": [list(s) for s in GALLERY_SHAPES], "write_s": write_s,
          "cli_s": cli_s, "images_per_s": GOD_IMAGES / cli_s,
          "decode_ms_per_image": decode_ms, "resize_ms_per_image": resize_ms,
          "card_vs_cpu": check})


# --- the repo's drivers: import CLI, feature dump, examples; Brennan spill --

DRIVER_RTOL = 1e-5     # f64 softmax of the attention maps vs the card's f32


def phase_spill_brennan(ds, seed, work) -> dict:
    """The Brennan spill path at full width (``brennan_cfg``, B = 64): the
    subject-wise set spilled through ``BrennanPacked.to_host``, its host
    batches through the prefetch against the device-resident batches on
    the same chunk and subject draws, the same init, cuDNN deterministic
    (``same_draw_runs``: eager and graph routes); the ms a step of each
    graph route.  Returns the launches of the four runs."""
    dev = torch.device("cuda")
    cfg = brennan_cfg(seed)
    cfg.num_subjects, cfg.num_channels = ds.num_subjects, int(ds.X.shape[2])
    loc = ch_locations_2d(cfg)
    loss_cfg = train_speech.loss_config(cfg)
    collate = evaluate_speech.collate_config(cfg)
    t0 = time.perf_counter()
    host = ds.to_host()
    spill_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed + 10)
    draws = [(rng.randint(0, len(ds), BATCH), rng.randint(0, ds.num_subjects, BATCH))
             for _ in range(SPILL_STEPS + 1)]

    def make_state():
        model = get_model(cfg, loc, device=dev, seed=seed,
                          num_channels=cfg.num_channels)
        opt = make_optimizer(cfg, SPILL_STEPS + 1)
        state = create_train_state(model, opt, float(cfg.init_temperature), seed)
        return model, state, make_train_step(model, opt, loss_cfg, collate)

    def batches_device():
        return (ds.gather(i, subject_idxs=s)[:3] for i, s in draws)

    def batches_spill():
        return prefetch_to_device((host.gather(i, subject_idxs=s)[:3]
                                   for i, s in draws), size=2, device=dev)

    torch.cuda.synchronize()
    reset_all_launches()
    check = same_draw_runs(make_state, batches_device, batches_spill)
    launches = brennan_launches()
    routes = len(SPILL_ROUTES)
    want = {"window_gather": 0, "robust_quantiles": 0,
            "bn_stats": routes * BN_PER_STEP * (SPILL_STEPS + 1),
            "bn_affine": routes * BN_PER_STEP * (SPILL_STEPS + 1),
            "bn_bwd_stats": routes * BN_PER_STEP * (SPILL_STEPS + 1),
            "robust_quantiles_long": 0}
    if launches != want:
        raise AssertionError(f"Brennan spill launches {launches}, expected {want}")
    emit({"phase": "spill_brennan", **check, "to_host_s": spill_s,
          "pinned": bool(host.X.is_pinned()), "host_bytes": int(
              host.X.numel() * 4 + host.Y.numel() * 4),
          "h2d_bytes_per_step": BATCH * int(ds.X.shape[2] * ds.X.shape[3]
                                            + ds.Y.shape[1] * ds.Y.shape[2]) * 4,
          "launches": launches})
    return launches


def phase_import_cli(cfg, seed, work) -> dict:
    """``configs/config.yaml`` at full width: a random encoder written as a
    reference ``.pt`` (``reference_state_dict``), imported through
    ``cli/import_torch_checkpoint.py:main`` (every entry bit-identical to
    the source model, the temperature ``init_temperature``), then the
    speech eval CLI on the speech cell's cache, the export CLI, and one
    artifact request at B = 64 against the source model's served forward
    (≤ EXPORT_RTOL · max|ref|).  Returns the save_root and the launches of
    the eval CLI and of the request."""
    from meg_decoding_tpu_torch.cli import export_model, import_torch_checkpoint

    dev = torch.device("cuda")
    loc = ch_locations_2d(cfg)
    model = get_model(cfg, loc, device=dev, seed=seed + 11)
    out = os.path.join(work, "import_cli")
    pt = os.path.join(work, "reference_speech.pt")
    torch.save(reference_state_dict(model.state_dict()), pt)
    keys = [f"cache_dir={cfg.cache_dir}", f"save_root={out}", f"seed={seed}",
            f"batch_size={BATCH}", f"num_subjects={cfg.num_subjects}",
            f"num_channels={C}"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = import_torch_checkpoint.main([pt, *keys, "--device", "cuda"])
    import_s = time.perf_counter() - t0
    saved = torch.load(path, map_location=dev, weights_only=True)["params"]
    temp = float(saved.pop("loss.temp"))
    src = model.state_dict()
    differ = [k for k in src if not torch.equal(saved[k], src[k])]
    if saved.keys() != src.keys() or differ or temp != float(
            np.float32(cfg.init_temperature)):
        raise AssertionError(f"import CLI: entries differ {differ}, "
                             f"temperature {temp}")
    result = {}
    ecfg = compose(CONFIGS_DIR, "config", keys)
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = evaluate_speech.run(ecfg, device="cuda")
    torch.cuda.synchronize()
    result["eval"] = {"seconds": time.perf_counter() - t0,
                      "launches": all_launches(), "result": ev}
    if not (0.0 <= ev["test_top1"] <= ev["test_top10"] <= 1.0
            and math.isfinite(ev["pairwise_correlation"])):
        raise AssertionError(f"import CLI → eval CLI: {ev}")
    t0 = time.perf_counter()
    art = export_model.run(compose(CONFIGS_DIR, "config", keys), device="cuda")
    export_s = time.perf_counter() - t0
    served = load_artifact(art, device="cuda")
    rng = np.random.RandomState(seed + 12)
    seq_len = int(cfg.preprocs.brain_resample_rate * cfg.preprocs.seq_len_sec)
    X = torch.from_numpy(rng.randn(BATCH, C, seq_len).astype(np.float32)).to(dev)
    subs = torch.from_numpy(rng.randint(0, int(cfg.num_subjects), BATCH)).to(dev)
    ref = make_serving_forward(evaluate_speech.collate_config(cfg))(model, X, subs)
    torch.cuda.synchronize()
    reset_all_launches()
    Z = served(X, subs)
    torch.cuda.synchronize()
    result["request"] = {"launches": all_launches()}
    err = rel_max(Z, ref)
    if not err <= EXPORT_RTOL or served.meta["checkpoint"] != "model_last":
        raise AssertionError(f"import CLI → export CLI: artifact vs source "
                             f"{err}, meta {served.meta}")
    emit({"phase": "import_cli", "width": {
        "C": C, "D1": int(cfg.D1), "D2": int(cfg.D2), "F": int(Z.shape[1]),
        "K": int(cfg.K), "S": int(cfg.num_subjects)}, "entries": len(src),
        "import_s": import_s, "eval_s": result["eval"]["seconds"],
        "export_s": export_s, "bit_identical_params": True,
        "artifact_vs_source_rel_err": err,
        "artifact_bit_identical": bool(torch.equal(Z, ref)),
        "limit": EXPORT_RTOL, "Z_shape": list(Z.shape), "eval": ev,
        "launches": {k: r["launches"] for k, r in result.items()}})
    return {"save_root": out, "keys": keys,
            **{f"import_cli_{k}": r["launches"] for k, r in result.items()}}


def phase_attention_maps(cfg, keys) -> None:
    """``examples/attention_check.py`` on ``import_cli``'s checkpoint: all
    270 maps over the 208 sensors on the card against a float64 NumPy
    softmax of the same basis; max error and the PNG's bytes."""
    from meg_decoding_tpu_torch.examples import attention_check
    from meg_decoding_tpu_torch.models.layers import fourier_basis

    acfg = compose(CONFIGS_DIR, "config", [*keys, f"n_maps={int(cfg.D1)}"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = attention_check.run(acfg, device="cuda")
    seconds = time.perf_counter() - t0
    saved = torch.load(os.path.join(acfg.save_root, "ckpt", "model_last.pt"),
                       map_location="cpu", weights_only=True)["params"]
    sa = "subject_block.spatial_attention."
    z_re, z_im = (saved[sa + n].double().numpy() for n in ("z_re", "z_im"))
    cos_t, sin_t = (t.astype(np.float64) for t in fourier_basis(
        out["loc"], int(cfg.K)))
    logits = z_re @ cos_t + z_im @ sin_t
    want = np.exp(logits - logits.max(-1, keepdims=True))
    want /= want.sum(-1, keepdims=True)
    got = out["weights"].double().cpu().numpy()
    err = float(np.abs(got - want).max() / want.max())
    if got.shape != (int(cfg.D1), C) or not err <= DRIVER_RTOL:
        raise AssertionError(f"attention maps: {got.shape}, rel err {err}")
    emit({"phase": "attention_maps", "maps": int(out["n_maps"]), "sensors": C,
          "seconds": seconds, "max_rel_err_vs_f64": err, "limit": DRIVER_RTOL,
          "png_bytes": os.path.getsize(out["png"])})


def phase_inference_dump(god_cfg, god_ds, seed, work) -> dict:
    """``config_GOD.yaml``'s encoder (F = 512) imported from a random
    reference ``.pt``, then ``examples/inference.py`` on the GOD cell (600
    train / 50 val trials): Z of both splits bit-identical to ``predict``
    of the source model, the files' shapes and dtypes.  Returns the dump's
    launches."""
    from meg_decoding_tpu_torch.cli import import_torch_checkpoint
    from meg_decoding_tpu_torch.examples import inference

    dev = torch.device("cuda")
    loc = ch_locations_2d(god_cfg, roi(god_cfg))
    cfg = Config(dict(to_dict(god_cfg), save_root=os.path.join(work, "dump"),
                      num_subjects=int(god_ds.num_subjects),
                      num_channels=len(loc)))
    model = get_model(cfg, loc, device=dev, seed=seed + 13,
                      num_channels=len(loc))
    pt = os.path.join(work, "reference_god.pt")
    torch.save(reference_state_dict(model.state_dict()), pt)
    t0 = time.perf_counter()
    import_torch_checkpoint.run(pt, cfg, device="cuda")
    import_s = time.perf_counter() - t0
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Z = inference.run(Config(to_dict(cfg)), device="cuda")
    torch.cuda.synchronize()
    dump_s = time.perf_counter() - t0
    launches = all_launches()
    val = build_god_dataset(cfg, "val", mean_X=god_ds.mean_X, std_X=god_ds.std_X,
                            mean_Y=god_ds.mean_Y, std_Y=god_ds.std_Y, device=dev)
    files = {}
    for split, ds in (("train", god_ds), ("test", val)):
        ref = evaluate_god.predict(cfg, model, ds)
        if not torch.equal(Z[split], ref):
            raise AssertionError(f"inference dump {split}: Z differs from the "
                                 f"source model's predict ({rel_max(Z[split], ref)})")
        for k in ("Z", "Y", "labels"):
            a = np.load(os.path.join(cfg.save_root, "inference", f"{k}_{split}.npy"),
                        mmap_mode="r")
            files[f"{k}_{split}"] = [list(a.shape), str(a.dtype)]
    want = {"Z_train": [[len(god_ds), int(cfg.F)], "float32"],
            "Z_test": [[len(val), int(cfg.F)], "float32"],
            "labels_test": [[len(val)], "int32"]}
    if any(files[k] != v for k, v in want.items()):
        raise AssertionError(f"inference dump files {files}")
    emit({"phase": "inference_dump", "import_s": import_s, "dump_s": dump_s,
          "files": files, "bit_identical": True, "launches": launches})
    return launches


def phase_kamitani_sweeps(god_cfg, work) -> dict:
    """The four sweeps of ``examples/kamitani_regression.py`` on the GOD
    cell at KAMITANI_ITERS iterations, each cut to 2 points: two onsets or
    ratios over the occipital region, the first reference channel list and
    the full ROI.  Accuracies and seconds; returns their launches."""
    from meg_decoding_tpu_torch.examples import kamitani_regression as sweeps

    occipital = ("occipital",)
    cuts = {"run_roi_onset_sweep": dict(onsets=(0.2, 0.25), roi_names=occipital),
            "run_channel_ratio_sweep": dict(ch_ratios=(0.5, 1.0),
                                            roi_names=occipital),
            "run_onsets_per_channel_sweep": dict(onsets=(0.2, 0.25),
                                                 roi_names=occipital),
            "run_manual_channel_sweep": dict(manual_ch_lists=(
                sweeps.MANUAL_CH_LISTS[0], None))}
    reset_all_launches()
    out = {}
    for name, cut in cuts.items():
        cfg = Config(dict(to_dict(god_cfg),
                          save_root=os.path.join(work, "sweeps", name)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = getattr(sweeps, name)(cfg, n_iter=KAMITANI_ITERS, device="cuda",
                                    **cut)
        torch.cuda.synchronize()
        accs = (list(res["occipital"].values()) if name == "run_roi_onset_sweep"
                else res["occipital"] if name == "run_channel_ratio_sweep"
                else res["acc"] if name == "run_onsets_per_channel_sweep"
                else res)
        if len(accs) != 2 or not all(0.0 <= a <= 1.0 for a in accs):
            raise AssertionError(f"Kamitani sweep {name}: {res}")
        out[name] = {"seconds": time.perf_counter() - t0, "accs": accs,
                     "cut": {k: [list(x) if isinstance(x, (list, tuple))
                                 else x for x in v] for k, v in cut.items()}}
    launches = all_launches()
    emit({"phase": "kamitani_sweeps", "iterations": KAMITANI_ITERS, **out,
          "reduced": "each sweep at 2 points over the occipital region (the "
                     "published sweeps: 8 onsets x 5 regions, 9 ratios x 31 "
                     "region sets, 3^5 onset assignments, 5 channel lists)",
          "launches": launches})
    return launches


def phase_quickstart(work) -> dict:
    """``examples/quickstart_synthetic.py`` on the card: the Gwilliams tour
    at the script's own widths and epochs (synthetic cache → train →
    evaluate → export → the artifact called).  Returns its launches."""
    from meg_decoding_tpu_torch.examples import quickstart_synthetic

    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = quickstart_synthetic.main(["--out", os.path.join(work, "quickstart"),
                                     "--dataset", "gwilliams", "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    best, Z = out["best"], out["served_Z"]
    if not (math.isfinite(best["train_loss"]) and math.isfinite(best["test_loss"])
            and Z.shape[:2] == (4, quickstart_synthetic.SPEECH_EXTRA["F"])
            and bool(torch.isfinite(Z).all())):
        raise AssertionError(f"quickstart: {best}, Z {tuple(Z.shape)}")
    emit({"phase": "quickstart", "seconds": seconds, "Z_shape": list(Z.shape),
          "best": {k: best[k] for k in ("epoch", "train_loss", "test_loss",
                                        "test_top10")},
          "eval": out["eval"], "launches": launches})
    return launches


BENCH_ARGS = ("--scale", "small", "--steps", "5", "--windows", "2",
              "--big-batches", "")
# the rows of bench_torch.py at those flags (B = 64, B2 = 256)
BENCH_ROWS = (
    "value", "vs_baseline", "device", "sec_per_step", "sec_per_step_windows",
    "mfu_vs_h100_f32_peak", "scan_epoch_samples_per_sec", "scan_epoch_mfu",
    "bf16_samples_per_sec", "bf16_mfu_vs_h100_bf16_peak",
    "collate_stats_sweep_sec", "collate_stats_hbm_gb",
    "cached_stats_samples_per_sec", "eval_ms_per_pool",
    "eval_sweep_epoch_fraction", "sentence_split_full_scale_ok",
    "scan_epoch_promoted_samples_per_sec", "scan_epoch_promoted_mfu",
    "b256_bf16_samples_per_sec", "b256_bf16_mfu_vs_h100_bf16_peak",
    "b256_bf16_peak_gb", "b256_samples_per_sec", "b256_mfu_vs_h100_f32_peak",
    "b256_peak_gb", "b256_bf16_cached_stats_samples_per_sec",
    "b256_bf16_cached_stats_mfu",
    "b256_bf16_cached_stats_gelu_tanh_samples_per_sec",
    "b256_bf16_cached_stats_gelu_tanh_mfu", "vs_baseline_1thread")


def phase_bench(smi: str) -> dict:
    """``bench_torch.py`` at the small scale (2 subjects × 2 sessions ×
    120 s, the full model width, B = 64 and 256) in a fresh process: every
    row present, none skipped or failed, the sentence split run, every MFU
    in (0, 1.05], the card named as nvidia-smi names it, and each kernel
    (``bn_bwd``, the fused BN backward, counted as ``bn_bwd_stats``, its
    sums alone apart) launched on the bench's path.  Returns its
    launches."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                          *BENCH_ARGS], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch.py printed {len(lines)} lines")
    row = json.loads(lines[0])
    missing = [k for k in BENCH_ROWS if k not in row]
    failed = [k for k in row if k.endswith(("_skipped", "_error"))]
    mfus = {k: v for k, v in row.items() if "mfu" in k}
    bad_mfu = {k: v for k, v in mfus.items()
               if v is None or not 0.0 < v <= 1.05}
    if missing or failed or bad_mfu or row["value"] <= 0:
        raise AssertionError(f"bench row: missing {missing}, skipped or "
                             f"failed {failed}, MFU out of (0, 1.05] "
                             f"{bad_mfu}, value {row['value']}")
    if row["sentence_split_full_scale_ok"] is not True:
        raise AssertionError("bench: the sentence split did not run")
    if row["device"] != smi:
        raise AssertionError(f"bench ran on {row['device']!r}, not {smi!r}")
    tagged = [ln.split(": ", 1)[1] for ln in out.stderr.splitlines()
              if ln.startswith("# bench-launches: ")]
    if len(tagged) != 1:
        raise AssertionError("bench: no bench-launches line")
    launches = json.loads(tagged[0])
    launches["bn_bwd"] = launches["bn_bwd_stats"] - launches["bn_bwd_sums_only"]
    for name in ("window_gather", "robust_quantiles", "bn_stats",
                 "bn_bwd_stats", "bn_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no launch on the bench path")
    emit({"phase": "bench", "seconds": time.perf_counter() - t0,
          "args": list(BENCH_ARGS), "mfu": mfus, "launches": launches,
          "row": row})
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke run of the port")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--phase", choices=("all", "brennan_kernels", "graphs", "serve_graphs",
                            "spill_dp", "bench", "gelu", "w2v",
                            "bn_time_major", "bn_affine", "moe", "adam",
                            "kimi"),
        default="all",
        help="brennan_kernels: build, then only that phase at Brennan's "
             "row length; copied into another checkout's root, it times that "
             "checkout's kernel the same way, for comparisons in turns; "
             "graphs / serve_graphs: build, the speech cache, that phase's "
             "speech paths, the GOD data and its GOD paths; spill_dp: build, "
             "the speech cache, unfused_step, spill_speech, data_parallel "
             "(speech), the GOD data, god_training, spill_god, "
             "data_parallel (GOD); bench: build, then only bench_torch.py "
             "at the small scale; gelu: build, the GELU kernels, then a "
             "captured full-width throughput_exact step; w2v: build, then "
             "only w2v_features; bn_time_major: build, the time-major BN "
             "route, then a captured full-width throughput step; bn_affine: "
             "build, the BN affine kernel, then captured full-width bf16 "
             "and f32 steps; moe: build, DeepSeek-V2-Lite's MoE route and "
             "combine kernels; adam: build, Adam's multi-tensor kernel, then "
             "captured full-width bf16, f32 and GOD steps; kimi: build, "
             "Kimi-Linear's KDA, convolution and sigmoid route kernels, "
             "then a small model's chunk graphs")
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
    smi = phase_device()
    lap("build")
    if args.phase == "bench":
        phase_bench(smi)
        lap("bench")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "w2v":
        phase_w2v_features(args.seed)
        lap("w2v_features")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "bn_time_major":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        phase_bn_time_major(flush)
        del flush
        lap("bn_time_major")
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            phase_bn_time_major_step(work, args.seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lap("bn_time_major_step")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "bn_affine":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            phase_bn_affine(flush, work)
            del flush
            lap("bn_affine")
            phase_bn_affine_steps(work, args.seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lap("bn_affine_steps")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "moe":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        phase_moe(flush)
        del flush
        lap("moe")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "kimi":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        phase_kimi(flush, args.seed)
        del flush
        lap("kimi")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "adam":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        phase_adam(flush)
        del flush
        lap("adam")
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            phase_adam_steps(work, args.seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lap("adam_steps")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "gelu":
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        phase_gelu(flush)
        del flush
        lap("gelu")
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            phase_gelu_step(work, args.seed)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lap("gelu_step")
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase in ("graphs", "serve_graphs"):
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            cfg, ds, tr_idx = full_width_speech(
                work, args.seed, [f"save_root={os.path.join(work, 'out')}",
                                  f"batch_size={BATCH}"])
            if args.phase == "graphs":
                phase_graphs_speech(cfg, ds, tr_idx, args.seed, smi)
            else:
                phase_serve_graphs_speech(cfg, ds, tr_idx, args.seed, work, smi)
            del ds
            lap(f"{args.phase}_speech")
            god_cfg, god_ds = phase_god_data(work, args.seed)
            if args.phase == "graphs":
                phase_graphs_god(god_cfg, god_ds, args.seed, smi)
            else:
                phase_serve_graphs_god(god_cfg, god_ds, args.seed, work, smi)
            lap(f"{args.phase}_god")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    if args.phase == "spill_dp":
        work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
        try:
            cfg, ds, tr_idx = full_width_speech(
                work, args.seed, [f"save_root={os.path.join(work, 'out')}",
                                  f"batch_size={BATCH}"])
            unfused = phase_unfused_step(cfg, ds, tr_idx, args.seed, work)
            phase_spill_speech(cfg, args.seed, work, unfused)
            lap("spill_speech")
            phase_dp_speech(cfg, ds, tr_idx, args.seed, work, smi)
            del ds
            lap("dp_speech")
            god_cfg, god_ds = phase_god_data(work, args.seed)
            god_training = phase_god_training(god_cfg, god_ds, args.seed)
            phase_spill_god(god_cfg, god_ds, args.seed, work,
                            god_training["launches"])
            lap("spill_god")
            phase_dp_god(god_cfg, god_ds, args.seed, work, smi)
            lap("dp_god")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
        return 0
    # The long-row percentile checks run first: their torch.profiler split
    # came back empty for most calls in a process that had already run the
    # later phases' profilers and process groups.
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    brennan_k = phase_brennan_kernels(BRENNAN_ROW_KEYS, flush)
    del flush
    lap("brennan_kernels")
    if args.phase == "brennan_kernels":
        return 0
    # the benchmark in a process of its own, before this one holds the
    # later phases' memory
    bench_launches = phase_bench(smi)
    lap("bench")

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
        bn_all = phase_bn_kernels(flush)
        bn = bn_all[str(torch.float32)]
        phase_bn_time_major(flush)
        affine = phase_bn_affine(flush, work)
        gelu = phase_gelu(flush)
        phase_moe(flush)
        phase_kimi(flush, args.seed)
        adam_rows = phase_adam(flush)
        del flush
        lap("kernels")
        serving = phase_serving(cfg, ds, tr_idx, args.seed)
        lap("serving")
        training = phase_training(cfg, ds, tr_idx, args.seed, work)
        lap("training")
        graphs = phase_graphs_speech(cfg, ds, tr_idx, args.seed, smi)
        lap("graphs_speech")
        phase_serve_graphs_speech(cfg, ds, tr_idx, args.seed, work, smi)
        lap("serve_graphs_speech")
        unfused = phase_unfused_step(cfg, ds, tr_idx, args.seed, work)
        lap("unfused_step")
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        presets = phase_presets(cfg, ds, tr_idx, args.seed, work, flush)
        del flush
        lap("presets")
        scan_speech = phase_scan_speech(cfg, ds, tr_idx, args.seed, work)
        lap("scan_speech")
        dp_speech = phase_dp_speech(cfg, ds, tr_idx, args.seed, work, smi)
        del ds
        lap("dp_speech")

        god_cfg, god_ds = phase_god_data(work, args.seed)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        god = phase_god_kernels(god_cfg, god_ds, flush)
        del flush
        god_training = phase_god_training(god_cfg, god_ds, args.seed)
        graphs.update(phase_graphs_god(god_cfg, god_ds, args.seed, smi))
        god_eval = phase_god_eval(god_cfg)
        scan_god = phase_scan_god(god_cfg, god_ds, args.seed)
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        zoo = phase_model_zoo(god_cfg, god_ds, args.seed, flush)
        del flush
        lap("god")
        phase_serve_graphs_god(god_cfg, god_ds, args.seed, work, smi)
        lap("serve_graphs_god")
        dp_god = phase_dp_god(god_cfg, god_ds, args.seed, work, smi)
        lap("dp_god")
        kamitani = phase_kamitani(god_cfg, work)
        lap("kamitani")

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
        if row_len != BRENNAN_ROW_KEYS:
            raise AssertionError(f"the Brennan build's rows hold {row_len} "
                                 f"keys; brennan_kernels checked "
                                 f"{BRENNAN_ROW_KEYS}")
        lap("brennan_data")
        brennan_train = phase_brennan_training(brennan_ds, args.seed)
        lap("brennan_training")
        spill_brennan = phase_spill_brennan(brennan_ds, args.seed, work)
        del brennan_ds
        lap("spill_brennan")
        brennan_cli = phase_brennan_cli(work, args.seed)
        lap("brennan_cli")

        phase_w2v_features(args.seed)
        lap("w2v_features")
        phase_clip_features(args.seed)
        lap("clip_features")
        phase_galleries(args.seed, work)
        lap("galleries")
        phase_gwilliams_preprocess(work, args.seed)
        lap("gwilliams_preprocess")
        brennan_embed = phase_brennan_embed_cli(work, args.seed)
        lap("brennan_embed_cli")
        god_error = phase_god_error_analysis(god_cfg, work, args.seed)
        lap("god_error_analysis")
        entry = phase_entry_points(god_cfg, work)
        lap("entry_points")

        # the repo's drivers of the package
        imported = phase_import_cli(cfg, args.seed, work)
        lap("import_cli")
        phase_attention_maps(cfg, imported["keys"])
        lap("attention_maps")
        dump = phase_inference_dump(god_cfg, god_ds, args.seed, work)
        lap("inference_dump")
        sweeps = phase_kamitani_sweeps(god_cfg, work)
        lap("kamitani_sweeps")
        quickstart = phase_quickstart(work)
        lap("quickstart")
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
    # the drivers' paths, each with the kernels it must launch
    driver_paths = {
        "import_cli_eval": (imported["import_cli_eval"],
                            ("window_gather", "robust_quantiles")),
        "import_cli_request": (imported["import_cli_request"],
                               ("robust_quantiles",)),
        "inference_dump": (dump, ("window_gather", "robust_quantiles")),
        "kamitani_sweeps": (sweeps, ("window_gather",)),
        "quickstart": (quickstart, ("window_gather", "robust_quantiles",
                                    "bn_stats", "bn_bwd_stats")),
        "spill_brennan": (spill_brennan, ("bn_stats", "bn_bwd_stats"))}
    for path, (launches, needed) in driver_paths.items():
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    for path, launches in (("serving", serving), ("training", training["launches"]),
                           *new_paths.items()):
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    # the data-parallel paths: every kernel of the step, BN by the split route
    dp_paths = {"dp_speech": dp_speech["steps"], "dp_speech_cli": dp_speech["cli"],
                "dp_speech_scan_cli": dp_speech["scan_cli"],
                "dp_god": dp_god["steps"]}
    for path, launches in dp_paths.items():
        needed = ("bn_stats", "bn_bwd_stats", "bn_bwd_sums_only", "bn_bwd_dx",
                  "robust_quantiles") + (("window_gather",) if "speech" in path else ())
        for name in needed:
            if launches[name] <= 0:
                raise AssertionError(f"{name}: no launch on the {path} path")
    if kamitani["window_gather"] <= 0:
        raise AssertionError("window_gather: no launch on the kamitani path")
    # bn_stats' routes on the paths that must take them: the speech step's
    # (64, 320, 360) and GOD's (64, 320, 24) one CTA a channel, EEGNet's
    # bn1 (64, 16, 528) the cluster route and its bn2/bn3 one CTA a
    # channel, Seq2Static's one CTA a channel
    route_paths = {"training": (training["stats_routes"], ("per_channel",)),
                   "god_training": (god_training["stats_routes"],
                                    ("per_channel",)),
                   "zoo_eegnet": (zoo["stats_routes"]["eegnet"],
                                  ("cluster", "per_channel")),
                   "zoo_brain_endcoder_seq2static": (
                       zoo["stats_routes"]["brain_endcoder_seq2static"],
                       ("per_channel",))}
    for path, (routes, needed) in route_paths.items():
        for route in needed:
            if routes[route] <= 0:
                raise AssertionError(f"bn_stats {route}: no launch on the "
                                     f"{path} path")
    paths = {"serving": serving, "training": training["launches"],
             "god_training": god_training["launches"], "god_eval": god_eval,
             **new_paths, **{k: v for k, (v, _) in brennan_paths.items()},
             **god_extra_paths, **artifact_spill_paths, **dp_paths,
             "kamitani_cli": kamitani,
             **{k: v for k, (v, _) in driver_paths.items()},
             "bench": bench_launches}
    for name in training["launches"]:
        if paths["god_training"][name] + paths["god_eval"][name] <= 0:
            raise AssertionError(f"{name}: no launch on the GOD paths")
    launches = {k: sum(p.get(k, 0) for p in paths.values())
                for k in (*training["launches"], "robust_quantiles_long")}
    by_path = lambda k: {p: n.get(k, 0) for p, n in paths.items()}
    adam_paths = {"training": training, "god_training": god_training}
    g = measured["gather"][:2]  # one batch: the X and the f32 Y gather
    q = measured["quantiles"]
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values()),
          "drivers": sum(seconds[k] for k in (
              "spill_brennan", "import_cli", "attention_maps", "inference_dump",
              "kamitani_sweeps", "quickstart"))})
    gq = god["quantiles"]
    at_god = lambda r: {k: r[k] for k in ("max_abs_err", "kernel_ms", "run_ms",
                                          "plain_ms", "library_ms",
                                          "stats_route", "host_us") if k in r}
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
                "bound_ms": r["bound_ms"] if "bound_ms" in r else r["bound_us"] / 1e3,
                **({"stats_route": r["stats_route"]} if "stats_route" in r else {})}
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
    dx_row = dp_speech["split"][str(torch.float32)]
    dx_keys = ("shape", "max_abs_err", "kernel_ms", "run_ms", "host_us",
               "plain_ms", "library_ms", "library_host_us",
               "library_max_abs_diff", "bound_ms")
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
         "pass_ms": bl["pass_ms"], "launches_per_call": bl["launches_per_call"],
         "candidate_bytes": bl["candidate_bytes"],
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
           **({"stats_route": bn[name]["stats_route"],
               "launches_by_route": {p: r for p, (r, _) in route_paths.items()},
               "routes_grid_max_abs_err": bn_all["routes"]["max_abs_err"]}
              if name == "bn_stats" else {}),
           **{k: bn[name][k] for k in extra}}
          for name, line, extra in (
              ("bn_stats", 69, ("library_batch_norm_stats_ms", "host_us",
                                "library_host_us")),
              # bn_bwd (sums and dx) above; its sums alone beside them
              ("bn_bwd_stats", 111, ("stats_only_ms", "stats_only_run_ms",
                                     "stats_only_library_ms")))),
        # synced BN's dx from all-reduced sums: with bn_bwd_stats's sums
        # alone, the split route that stands for the Pallas bn_bwd_stats's
        # custom VJP under data parallelism
        {"name": "bn_bwd_dx", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/batchnorm_stats.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/batchnorm.py:111",
         "launches": sum(n["bn_bwd_dx"] for n in dp_paths.values()),
         "launches_by_path": {p: n["bn_bwd_dx"] for p, n in dp_paths.items()},
         "max_abs_err": dx_row["max_abs_err"], "ms": dx_row["kernel_ms"],
         "run_ms": dx_row["run_ms"], "plain_ms": dx_row["plain_ms"],
         "bound_ms": dx_row["bound_ms"], "bound_by": dx_row["bound_by"],
         "library_ms": dx_row["library_ms"], "shape": dx_row["shape"],
         "host_us": dx_row["host_us"], "library_host_us": dx_row["library_host_us"],
         "god": {k: dp_god["split"][str(torch.float32)][k] for k in dx_keys},
         "more_shapes": {
             "bf16": {k: dp_speech["split"][str(torch.bfloat16)][k] for k in dx_keys},
             "god bf16": {k: dp_god["split"][str(torch.bfloat16)][k]
                          for k in dx_keys}}},
        # the training forward's affine from bn_stats' sums: no Pallas
        # kernel, XLA fused the JAX package's jnp affine
        {"name": "bn_affine", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/batchnorm_stats.cu",
         "replaces": "none (XLA fused meg_decoding_tpu/ops/pallas/"
                     "batchnorm.py:194-202)",
         "launches": launches["bn_affine"],
         "launches_by_path": by_path("bn_affine"), "bound_by": "bytes",
         "by_shape": affine["rows"]},
        # the erf_poly GELU, forward and backward: no Pallas kernel, XLA
        # fused the JAX package's jnp chain; per exact-GELU step (B = 256,
        # bf16) and by shape
        {"name": "gelu_erf_poly", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/gelu_erf_poly.cu",
         "replaces": "none (XLA fused meg_decoding_tpu/ops/gelu.py:95-137)",
         "launches_by_path": {f"preset_{k}": v for k, v in
                              presets["gelu_launches"].items()},
         "per_step": gelu["per_step"], "bound_by": "bytes",
         "by_shape": {f"{tuple(r['shape'])} {r['dtype']}": {
             k: {m: r[k][m] for m in ("kernel_ms", "run_ms", "plain_ms",
                                      "library_ms", "bound_ms", "max_abs_err")}
             for k in ("fwd", "bwd")} for r in gelu["rows"].values()}},
        # Adam's update of the parameter list: no Pallas kernel, XLA fused
        # the JAX package's optax.adam; one launch an update on the card
        {"name": "adam_multi_tensor", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/adam.cu",
         "replaces": "none (XLA fused optax.adam)",
         "launches": sum(p["adam"]["multi_tensor"] for p in adam_paths.values()),
         "launches_by_path": {k: p["adam"] for k, p in adam_paths.items()},
         "bound_by": "bytes",
         "by_list": {kind: {k: r[k] for k in (
             "tensors", "elements", "launches_a_call", "check", "kernel_ms",
             "run_ms", "plain_ms", "library_ms", "host_us", "bound_ms",
             "run_share_of_bound")} for kind, r in adam_rows.items()}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
