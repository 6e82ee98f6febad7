"""Gwilliams2022 training throughput of the port on one card, at the
dataset's full scale.  Port of the repo-root ``bench.py`` (the JAX
package's benchmark); ``bench_torch.py`` at the repository root runs it.

The packed set is the real dataset's size, made from seed 0 on the device:
27 subjects × 2 sessions × 4 tasks × 208 channels × 392 s at 120 Hz
(47,040 samples, padded to 47,616 by ``pad_time_for_gather``) and the
(4, 1024, 47,616) embedding streams, 9.34 GB resident; 2,000 words a
task, their onsets drawn from ``np.random.RandomState(0)`` exactly as
``bench.py`` draws them, so both benches cut the same windows (the values
of the recordings differ: ``torch.randn`` is not ``jax.random``).

Every row times the route a user of the port takes: the fused speech step
(session draw, two window gathers, collate, seq2seq ``BrainEncoder`` with
D1 = 270, D2 = 320, F = 1024, K = 32, CLIP loss, backward, Adam, BN running
statistics) replayed as one captured CUDA graph (``train/graph.py``, as
``fit`` runs it), the whole-epoch form (``ScanEpoch``), and the test
pool's eval graph.  Rows, in ``bench.py``'s order: f32 B = 64 (the
headline), its whole epoch of 20 updates, bf16 B = 64, the sweep of the
cached collate statistics (432,000 windows, a 0.72 GB table) and the f32
step on it, one eval pool, the sentence split of the full set (train and
test packs alias one copy of the recordings), the promoted recipe (whole
epoch, bf16, cached statistics, tanh GELU, B = 256), then the batch
scaling rows (B = 256 and ``--big-batches``, bf16 before f32, the two
cached rows at B = 256) behind a capacity pre-check.

Each timed row warms up (the capture and 3 replays), then times
``--windows`` windows of ``--steps`` steps, each window closed by
``torch.cuda.synchronize()``; the row reports the best window, the
headline every window too.  The final loss is read once and must be
finite.  After every row the row's step, graph and state are dropped and
the allocator's cache emptied, so no row runs beside an earlier row's
graph memory.

MFU is the model FLOPs of a step (``analytic_step_flops``, ``bench.py``'s
count) over the step time and NVIDIA's data-sheet peak of an H100 SXM at
700 W: 67 TFLOP/s for the f32 rows (TF32 is off, ``device.py``) and
989 TFLOP/s for the bf16 rows.  The row carries the card's name and power
limit (``device``); on the CPU every MFU is null.

An out-of-memory error in a row makes it a ``_skipped`` row; any other
error ends the run with a nonzero exit, after the rows measured so far
(streamed to stderr after each section as ``# bench-partial:`` lines).
Without a card (and without ``--device cpu``) it prints one error row and
exits 1.  After the row, stderr gets ``# bench-launches: {...}``: each
kernel's launches in the run (a graph replay credited with its capture's).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Run from the repository root: ``python3 bench_torch.py [--scale
full|small] [--tiny] [--device cpu] [--steps N] [--windows N]
[--big-batches 512,1024] [--hbm-budget-gb GB]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from meg_decoding_tpu_torch.cli.profile_train_step import nvidia_smi
from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.data.gwilliams import (
    SWEEP_CHUNK,
    GwilliamsPacked,
    compute_collate_stats,
    gather_speech_batch,
)
from meg_decoding_tpu_torch.data.layout import (
    normalize_locations,
    synthetic_cap_locations,
)
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from meg_decoding_tpu_torch.ops.kernels import batchnorm as bk
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import quantile as qk
from meg_decoding_tpu_torch.ops.kernels import reset_launches
from meg_decoding_tpu_torch.ops.kernels import window_gather as wg
from meg_decoding_tpu_torch.train import loop
from meg_decoding_tpu_torch.train.scan_loop import (
    make_fused_speech_step,
    make_gwilliams_scan_epoch,
)
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import (
    CollateConfig,
    LossConfig,
    make_eval_step,
)

__all__ = ["make_synthetic_packed", "analytic_step_flops",
           "estimate_step_hbm_gb", "precheck", "oom_skip_reason",
           "make_model", "train_route", "eval_route", "time_steps",
           "kernel_launches", "main"]

METRIC = "gwilliams_train_samples_per_sec_per_chip"
# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
H100_F32_PEAK = 67e12    # f32 outside the tensor cores
H100_BF16_PEAK = 989e12  # bf16 tensor cores
LR = 3e-4
LOSS = LossConfig(kind="clip")
COLLATE = CollateConfig(baseline_len_samp=60, clamp_lim=20.0)
# params, optimizer state and workspace beside the resident set (bench.py:587)
RESIDENT_OVERHEAD_GB = 0.3
EPOCH_UPDATES = 20         # the whole-epoch rows
EVAL_POOLS = 5             # pools a timed eval window
FIT_UPDATES = 1200         # the epoch an eval sweep is a fraction of
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_synthetic_packed(C: int, F: int, rate: int, rec_sec: float,
                          words_per_task: int, n_subjects: int,
                          n_sessions: int, seq_len_sec: float,
                          device="cuda") -> GwilliamsPacked:
    """The synthetic packed Gwilliams set of ``bench.py:_make_synthetic_packed``
    (``:40-78``): recordings (S·sessions, 4, C, Tp) and streams (4, F, Tp)
    drawn on ``device`` with ``torch.randn`` from a generator seeded 0 (no
    multi-GB copy from the host), onsets from ``RandomState(0)`` as
    ``bench.py`` draws them."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    T = int(rec_sec * rate)
    seq_len = int(seq_len_sec * rate)
    Tp = wg.pad_time_for_gather(T, seq_len)
    n_sess_total = n_subjects * n_sessions
    gen = torch.Generator(device=dev).manual_seed(0)
    recordings = torch.randn((n_sess_total, 4, C, Tp), generator=gen,
                             device=dev)
    y_stream = torch.randn((4, F, Tp), generator=gen, device=dev)
    onsets = np.sort(
        rng.randint(0, T - seq_len, size=(4, words_per_task))).astype(np.int32)
    meg_onsets = np.broadcast_to(onsets[None], (n_sess_total, 4, words_per_task))
    session_subject = np.repeat(np.arange(n_subjects), n_sessions)
    return GwilliamsPacked(
        recordings=recordings,
        y_stream=y_stream,
        meg_onsets=torch.from_numpy(np.ascontiguousarray(meg_onsets)).to(dev),
        speech_onsets=torch.from_numpy(onsets).to(dev),
        n_words=np.full(4, words_per_task),
        session_subject=torch.from_numpy(session_subject).to(dev),
        seq_len=seq_len,
        num_subjects=n_subjects,
    )


def analytic_step_flops(B, C, T, D1, D2, F, K):
    """Model FLOPs per train step, ``bench.py:_analytic_step_flops``: conv
    and matmul MACs × 2 for the forward pass, × 3 for forward + backward
    (elementwise ops ignored)."""
    fwd = 0.0
    fwd += 2 * D1 * K * K * C            # spatial-attention map build
    fwd += 2 * B * T * D1 * C            # attention apply einsum
    fwd += 2 * B * T * D1 * D1 * 2       # 1x1 conv + per-subject 1x1 conv
    cin = D1
    for _ in range(5):                   # ConvBlocks: k=3 convs
        fwd += 2 * B * T * D2 * cin * 3
        fwd += 2 * B * T * D2 * D2 * 3
        fwd += 2 * B * T * (2 * D2) * D2 * 3
        cin = D2
    fwd += 2 * B * T * (2 * D2) * D2     # conv_final1 (k=1)
    fwd += 2 * B * T * F * (2 * D2)      # conv_final2 (k=1)
    fwd += 2 * B * B * F * T             # CLIP logits over flattened (F·T)
    return 3.0 * fwd


def estimate_step_hbm_gb(B, C, T, D1, D2, F, dtype_bytes):
    """``bench.py:_estimate_step_hbm_gb``: the working set of one seq2seq
    train step (GB) if only the conv-adjacent tensors are kept (XLA's
    fusion), the gathered Y block and the (B, B) f32 logits; no safety
    factor.  The port's eager autograd keeps more: each batch row reports
    its measured peak beside this."""
    per_sample_floats = (
        C                      # input X
        + 3 * D1               # SA out, 1x1 conv out, subject-layer out
        + 5 * 4 * D2           # per ConvBlock: conv0/conv1 outs, conv2a/b
        + 2 * D2               # conv_final1 out
        + 2 * F                # conv_final2 out (Z) + gathered Y row
    ) * T
    act = B * per_sample_floats * dtype_bytes
    logits = B * B * 4
    return (act + logits) / 1e9


def precheck(resident_gb, budget_gb, B, C, T, D1, D2, F, dtype_bytes):
    """``(estimate, skip)``: a batch row's estimated residency in GB (the
    resident set and overhead, plus ``estimate_step_hbm_gb``) and whether
    the capacity pre-check skips it (the estimate exceeds the budget)."""
    est = resident_gb + estimate_step_hbm_gb(B, C, T, D1, D2, F, dtype_bytes)
    return est, est > budget_gb


def oom_skip_reason(e: BaseException) -> str | None:
    """``"oom_at_runtime"`` when ``e``, or an error it was raised from or
    during, is an out-of-memory error: ``torch.OutOfMemoryError``, the
    CUDA runtime's "out of memory", or cuBLAS/cuDNN's ``ALLOC_FAILED``;
    else None (the error ends the run)."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        msg = f"{type(e).__name__}: {e}".lower()
        if isinstance(e, torch.OutOfMemoryError) or "out of memory" in msg \
                or "alloc_failed" in msg:
            return "oom_at_runtime"
        e = e.__cause__ or e.__context__
    return None


def make_model(loc, num_subjects: int, D1: int, D2: int, F: int, K: int,
               dtype, gelu_tanh: bool, device, seed: int = 0) -> BrainEncoder:
    """The seq2seq encoder of ``bench.py`` on ``device``, its weights drawn
    from a generator seeded ``seed`` (``models/factory.py``'s way)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return BrainEncoder(loc, num_subjects, D1=D1, D2=D2, F=F, K=K,
                        seq2seq=True, dtype=dtype, gelu_approximate=gelu_tanh,
                        device=device, generator=gen)


def _optimizer():
    """``optax.adam(3e-4)``: Adam at a constant learning rate."""
    return make_optimizer(Config({"lr": LR, "epochs": 1}), 1)


def train_route(model, packed: GwilliamsPacked, collate_stats=None):
    """``(state, step)``: a fresh train state (Adam at 3e-4) and
    ``step(idx, generator=None, sess_ids=None) → metrics``, one fused
    speech step over ``packed`` (sessions drawn with ``generator`` unless
    given) replayed as a captured CUDA graph, through ``fit``'s own
    route (``train/loop.py:train_route``).  ``collate_stats``: the
    set's collate-stats table, read instead of the percentiles."""
    opt = _optimizer()
    state = create_train_state(model, opt)
    fused = make_fused_speech_step(model, opt, LOSS, COLLATE, packed,
                                   collate_stats=collate_stats)
    return state, loop.train_route(fused, state)


def eval_route(model, state):
    """``pool(X, Y, subject_idxs) → metrics``: the eval step on one
    gathered pool with the state's temperature, replayed as the test
    pools' graph (``train/loop.py:eval_route``)."""
    run = loop.eval_route(make_eval_step(model, LOSS, COLLATE), state)
    return lambda X, Y, subs: run(X, Y, subs, state.temp.detach())[0]


def time_steps(step, n_segments: int, batch: int, n_steps: int,
               n_windows: int, rng: np.random.RandomState, sync):
    """``bench.py:_time_steps``: ``step(idx, i) → metrics`` with ``idx``
    drawn from ``rng`` before each call; step 1 (the capture) and steps
    2–4 warm up, then ``n_windows`` windows of ``n_steps`` steps, step
    100 + w·n_steps + j, each closed by ``sync()``.  Returns (the seconds
    a step of each window, every step's metrics in order)."""
    history = []

    def one(i):
        history.append(step(rng.randint(0, n_segments, batch), i))

    one(1)
    sync()
    for i in range(3):
        one(2 + i)
    sync()
    windows = []
    for w in range(n_windows):
        t0 = time.perf_counter()
        for i in range(n_steps):
            one(100 + w * n_steps + i)
        sync()
        windows.append((time.perf_counter() - t0) / n_steps)
    return windows, history


def _require_finite(metrics: dict, what: str) -> None:
    """One read of the loss (and the skip flag, where the step has one)."""
    loss = metrics["loss"]
    loss, skipped = (float(v) for v in torch.stack(
        [loss, metrics.get("skipped", torch.zeros_like(loss))]))
    if not np.isfinite(loss) or skipped != 0.0:
        raise FloatingPointError(f"{what}: final loss {loss}, skipped {skipped}")


def kernel_launches() -> dict:
    """Each kernel's launches since the run began (``bn_bwd_stats``: the
    fused BN backward ``bn_bwd``; ``bn_bwd_sums_only``: its sums alone)."""
    return {"window_gather": wg.launches, "robust_quantiles": qk.launches,
            "robust_quantiles_long": qk.long_launches, **bk.launches,
            "bn_bwd_sums_only": bk.sums_only_launches,
            "bn_bwd_dx": bk.dx_launches}


def _guarded(run):
    """``(run(), None)``, or ``(None, reason)`` after an out-of-memory
    error; any other error propagates."""
    try:
        return run(), None
    except Exception as e:  # noqa: BLE001 — classified, re-raised unless OOM
        reason = oom_skip_reason(e)
        if reason is None:
            raise
    return None, reason


def _release(dev: torch.device) -> None:
    """Free what the last row left: its graphs' pools and the cache."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _total_memory_gb(dev: torch.device) -> float:
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] / 1e9
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=["full", "small"], default="full",
                    help="full = real Gwilliams dims (27x2 sessions, 392 s); "
                         "small = quick smoke (2x2 sessions, 120 s)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card prints "
                         "an error row and exits 1")
    ap.add_argument("--big-batches", default="512,1024",
                    help="comma list of extra batch sizes for the scaling "
                         "curve (each row OOM-guarded); '' disables")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="usable device memory for the capacity pre-check "
                         "(default 0.9 x the card's total); batch rows whose "
                         "estimated residency exceeds it are skipped rows")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke mode: tiny model and batch dims, so every row "
                         "runs in seconds on the CPU (its numbers mean "
                         "nothing; it checks the bench itself)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(json.dumps({"metric": METRIC, "value": 0.0,
                          "unit": "samples/sec", "vs_baseline": 0.0,
                          "error": str(e)}))
        return 1
    on_card = dev.type == "cuda"
    if on_card:
        build.build()  # every kernel, one nvcc a source, in parallel
        sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    else:
        sync = lambda: None  # noqa: E731
    device_name = nvidia_smi() if on_card else "cpu"

    def mfu(flops: float, sec: float, peak: float) -> float | None:
        return round(flops / sec / peak, 4) if on_card else None

    def peak_gb() -> float | None:
        return (round(torch.cuda.max_memory_allocated(dev) / 1e9, 2)
                if on_card else None)

    def reset_peak() -> None:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

    B, C, F = 64, 208, 1024
    D1, D2, K = 270, 320, 32
    B2 = 256  # throughput-optimal batch rows
    if args.scale == "full":
        S, n_sessions, rec_sec, words = 27, 2, 392.0, 2000
    else:
        S, n_sessions, rec_sec, words = 2, 2, 120.0, 120
    if args.tiny:
        B, C, F, D1, D2, K, B2 = 8, 12, 16, 8, 12, 4, 16
        S, n_sessions, rec_sec, words = 2, 2, 30.0, 24
    packed = make_synthetic_packed(C=C, F=F, rate=120, rec_sec=rec_sec,
                                   words_per_task=words, n_subjects=S,
                                   n_sessions=n_sessions, seq_len_sec=3,
                                   device=dev)
    seq_len = packed.seq_len
    hbm_gb = (packed.recordings.numel() + packed.y_stream.numel()) * 4 / 1e9
    budget_gb = (args.hbm_budget_gb if args.hbm_budget_gb is not None
                 else 0.9 * _total_memory_gb(dev))
    loc = normalize_locations(synthetic_cap_locations(C))
    rng = np.random.RandomState(0)
    reset_launches()

    def model(dtype=None, gelu_tanh=False, seed=0):
        return make_model(loc, S, D1, D2, F, K, dtype, gelu_tanh, dev, seed)

    def sweep(chunk=SWEEP_CHUNK):
        stats = compute_collate_stats(packed, COLLATE.baseline_len_samp,
                                      chunk=chunk)
        sync()
        return stats

    def bench_dtype(dtype, batch=B, cache_stats=None, gelu_tanh=False):
        """Seconds a step of each timed window of the graphed fused step."""
        _, step = train_route(model(dtype, gelu_tanh), packed, cache_stats)
        windows, history = time_steps(
            lambda idx, i: step(idx, torch.Generator().manual_seed(i)),
            len(packed), batch, args.steps, args.windows, rng, sync)
        _require_finite(history[-1], f"B={batch} {dtype} step")
        return windows

    def bench_scan_epoch(dtype, batch=B, cache_stats=False, gelu_tanh=False):
        """Seconds an update of the best whole epoch."""
        m = model(dtype, gelu_tanh)
        opt = _optimizer()
        state = create_train_state(m, opt)
        epoch = make_gwilliams_scan_epoch(
            m, opt, LOSS, COLLATE, packed, updates=EPOCH_UPDATES,
            batch_size=batch, cache_collate_stats=cache_stats)
        gen = lambda k: torch.Generator(device=dev).manual_seed(k)  # noqa: E731
        epoch(state, gen(1))
        sync()
        best = float("inf")
        for w in range(args.windows):
            t0 = time.perf_counter()
            _, means = epoch(state, gen(2 + w))
            sync()
            best = min(best, time.perf_counter() - t0)
        _require_finite(means, f"B={batch} {dtype} epoch")
        return best / EPOCH_UPDATES

    def bench_eval():
        """Seconds a pool (gather + eval graph) of the best window."""
        m = model()
        pool = eval_route(m, create_train_state(m, _optimizer()))

        def one_pool(i):
            idx = rng.randint(0, len(packed), B)
            X, Y, subs, _ = gather_speech_batch(
                packed, idx, generator=torch.Generator().manual_seed(i))
            return pool(X, Y, subs)

        one_pool(0)
        sync()
        best = float("inf")
        for w in range(args.windows):
            t0 = time.perf_counter()
            for i in range(EVAL_POOLS):
                metrics = one_pool(10 + w * EVAL_POOLS + i)
            sync()
            best = min(best, (time.perf_counter() - t0) / EVAL_POOLS)
        _require_finite(metrics, "eval pool")
        return best

    def split_check():
        """Three train steps on the sentence split's train pack and one
        eval pool on its test pack, both aliasing the full set."""
        words_total = int(packed.n_words[0])
        n_tr = int(words_total * 0.8)
        tr = dataclasses.replace(
            packed, meg_onsets=packed.meg_onsets[:, :, :n_tr],
            speech_onsets=packed.speech_onsets[:, :n_tr],
            n_words=np.full(4, n_tr), _seg_table=None)
        te = dataclasses.replace(
            packed, meg_onsets=packed.meg_onsets[:, :, n_tr:],
            speech_onsets=packed.speech_onsets[:, n_tr:],
            n_words=np.full(4, words_total - n_tr), _seg_table=None)
        if tr.recordings is not packed.recordings \
                or te.y_stream is not packed.y_stream:
            raise AssertionError("the split copied the resident set")
        m = model(seed=1)
        state, step = train_route(m, tr)
        for i in range(3):
            metrics = step(rng.randint(0, len(tr), B),
                           torch.Generator().manual_seed(100 + i))
        X, Y, subs, _ = gather_speech_batch(
            te, rng.randint(0, len(te), B),
            generator=torch.Generator().manual_seed(200))
        _require_finite(metrics, "split train step")
        _require_finite(eval_route(m, state)(X, Y, subs), "split eval pool")

    def report(extras_now):
        print("# bench-partial: " + json.dumps(extras_now), file=sys.stderr,
              flush=True)

    windows_f32 = bench_dtype(None)
    _release(dev)
    dt_f32 = min(windows_f32)
    sps = B / dt_f32
    flops = analytic_step_flops(B, C, seq_len, D1, D2, F, K)
    dt_scan = bench_scan_epoch(None)
    _release(dev)

    extras = {
        "device": device_name,
        "torch": torch.__version__,
        "hbm_resident_dataset_gb": round(hbm_gb, 2),
        "hbm_budget_gb": round(budget_gb, 2),
        "scale": "tiny" if args.tiny else args.scale,
        "sec_per_step": round(dt_f32, 5),
        "sec_per_step_windows": [round(w, 5) for w in windows_f32],
        "model_flops_per_step": flops,
        "mfu_vs_h100_f32_peak": mfu(flops, dt_f32, H100_F32_PEAK),
        "scan_epoch_samples_per_sec": round(B / dt_scan, 2),
        "scan_epoch_mfu": mfu(flops, dt_scan, H100_F32_PEAK),
    }
    report(extras)
    dt_bf16 = min(bench_dtype(torch.bfloat16))
    _release(dev)
    extras["bf16_samples_per_sec"] = round(B / dt_bf16, 2)
    extras["bf16_mfu_vs_h100_bf16_peak"] = mfu(flops, dt_bf16, H100_BF16_PEAK)
    report(extras)

    # the per-window RobustScaler fits, swept once (0.72 GB at full scale);
    # a sweep denied memory is retried once in chunks of 128
    t0 = time.perf_counter()
    stats, reason = _guarded(sweep)
    _release(dev)
    if reason:
        extras["collate_stats_sweep_retry"] = reason
        t0 = time.perf_counter()
        stats, reason = _guarded(lambda: sweep(chunk=128))
        _release(dev)
        if reason:
            extras["collate_stats_sweep_skipped"] = reason
    if stats is not None:
        extras["collate_stats_sweep_sec"] = round(time.perf_counter() - t0, 2)
        extras["collate_stats_hbm_gb"] = round(stats.numel() * 4 / 1e9, 2)
        windows, reason = _guarded(lambda: bench_dtype(None, cache_stats=stats))
        del stats
        _release(dev)
        if reason:
            extras["cached_stats_skipped"] = reason
        else:
            extras["cached_stats_samples_per_sec"] = round(B / min(windows), 2)
    report(extras)

    # the trainer scores every test pool each epoch: one pool's cost, and
    # the share of an epoch (FIT_UPDATES steps) the test sweep takes
    dt_eval, reason = _guarded(bench_eval)
    _release(dev)
    if reason:
        extras["eval_sweep_skipped"] = reason
    else:
        n_test = max(int(0.2 * len(packed)), B)  # the 80/20 split's test segments
        n_pools = max(n_test // B, 1)
        extras["eval_ms_per_pool"] = round(dt_eval * 1e3, 2)
        extras["eval_sweep_epoch_fraction"] = round(
            (n_pools * dt_eval) / (FIT_UPDATES * dt_f32), 4)
    report(extras)

    _, reason = _guarded(split_check)
    _release(dev)
    extras["sentence_split_full_scale_ok"] = reason is None
    if reason:
        extras["sentence_split_skipped"] = reason
    else:
        extras["sentence_split_hbm_gb"] = round(hbm_gb, 2)
    report(extras)

    # the promoted recipe on the whole-epoch form: bf16, cached statistics,
    # tanh GELU, the throughput-optimal batch
    dt_sp, reason = _guarded(lambda: bench_scan_epoch(
        torch.bfloat16, batch=B2, cache_stats=True, gelu_tanh=True))
    _release(dev)
    if reason:
        extras["scan_epoch_promoted_skipped"] = reason
    else:
        extras["scan_epoch_promoted_samples_per_sec"] = round(B2 / dt_sp, 2)
        extras["scan_epoch_promoted_mfu"] = mfu(
            analytic_step_flops(B2, C, seq_len, D1, D2, F, K), dt_sp,
            H100_BF16_PEAK)
    report(extras)

    batches = [B2] + ([] if args.tiny else
                      [int(b) for b in args.big_batches.split(",") if b])
    best_bf16_sps, best_bf16_batch = 0.0, B2

    def cached_row(bb, gelu_tanh=False, stats_table=None):
        """bf16 at batch ``bb`` on the cached statistics: the shared table
        when given, else a sweep of its own."""
        key = f"b{bb}_bf16_cached_stats" + ("_gelu_tanh" if gelu_tanh else "")
        windows, reason = _guarded(lambda: bench_dtype(
            torch.bfloat16, batch=bb, gelu_tanh=gelu_tanh,
            cache_stats=stats_table if stats_table is not None else sweep()))
        _release(dev)
        if reason:
            extras[f"{key}_skipped"] = reason
        else:
            extras[f"{key}_samples_per_sec"] = round(bb / min(windows), 2)
            extras[f"{key}_mfu"] = mfu(
                analytic_step_flops(bb, C, seq_len, D1, D2, F, K),
                min(windows), H100_BF16_PEAK)
        report(extras)

    resident_gb = hbm_gb + RESIDENT_OVERHEAD_GB
    for bx in batches:
        flops_b = analytic_step_flops(bx, C, seq_len, D1, D2, F, K)
        # bf16 before f32 at each size: the smaller row first
        for dtype, tag in ((torch.bfloat16, "bf16_"), (None, "")):
            est_gb, skip = precheck(resident_gb, budget_gb, bx, C, seq_len,
                                    D1, D2, F, 2 if dtype is not None else 4)
            extras[f"b{bx}_{tag}est_hbm_gb"] = round(est_gb, 2)
            if skip:
                extras[f"b{bx}_{tag}skipped"] = "exceeds_hbm_estimate"
                report(extras)
                continue
            reset_peak()
            windows, reason = _guarded(lambda: bench_dtype(dtype, batch=bx))
            extras[f"b{bx}_{tag}peak_gb"] = peak_gb()
            _release(dev)
            if reason:
                extras[f"b{bx}_{tag}skipped"] = reason
                report(extras)
                continue
            dt_b = min(windows)
            extras[f"b{bx}_{tag}samples_per_sec"] = round(bx / dt_b, 2)
            if tag:
                extras[f"b{bx}_bf16_mfu_vs_h100_bf16_peak"] = mfu(
                    flops_b, dt_b, H100_BF16_PEAK)
                if bx / dt_b > best_bf16_sps:
                    best_bf16_sps, best_bf16_batch = bx / dt_b, bx
            else:
                extras[f"b{bx}_mfu_vs_h100_f32_peak"] = mfu(
                    flops_b, dt_b, H100_F32_PEAK)
            report(extras)
        if bx == B2:
            # one table for both B2 rows; each sweeps its own if the shared
            # sweep was denied memory
            stats_b2, _ = _guarded(sweep)
            _release(dev)
            cached_row(B2, stats_table=stats_b2)
            cached_row(B2, gelu_tanh=True, stats_table=stats_b2)
            del stats_b2
            _release(dev)

    if best_bf16_batch != B2:
        cached_row(best_bf16_batch)

    baseline_path = os.path.join(_ROOT, "tools", "baseline_measured.json")
    vs = None
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            base = json.load(f)
        vs_measured = sps / base["torch_cpu_train_samples_per_sec"]
        threads = base.get("num_threads") or 1
        extras["baseline_num_threads"] = threads
        if threads < 20:
            # bench.py's headline: the reference's 20-core framing,
            # extrapolated with perfect scaling from the measured threads
            vs = vs_measured * threads / 20.0
            extras["vs_baseline_basis"] = "20core_perfect_scaling_extrapolation"
            extras["vs_baseline_1core_measured"] = round(vs_measured, 2)
        else:
            vs = vs_measured
        if "torch_cpu_train_samples_per_sec_1thread" in base:
            extras["vs_baseline_1thread"] = round(
                sps / base["torch_cpu_train_samples_per_sec_1thread"], 2)
    extras["wall_sec"] = round(time.perf_counter() - t_start, 1)

    print(json.dumps({
        "metric": METRIC,
        "value": round(sps, 2),
        "unit": "samples/sec",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        **extras,
    }), flush=True)
    print("# bench-launches: " + json.dumps(kernel_launches()),
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
