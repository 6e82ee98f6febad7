#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (meg_decoding_tpu_torch).

Drives the port's Gwilliams2022 serving and eval path on one NVIDIA GPU at
the full width of the speech model in ``configs/config.yaml`` (C = 208,
D1 = 270, D2 = 320, F = 1024, K = 32, 5 ConvBlocks, seq2seq, T = 360,
27 subjects, batch 64), with random weights from ``--seed``.  Phases, each
printed as one JSON line:

1. build   — compile both CUDA kernels from ``meg_decoding_tpu_torch/csrc``
             (one nvcc per source, in parallel);
2. device  — the card's name and power limit, as nvidia-smi reports them;
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (gather bit-exact, percentiles ≤ 1 ulp),
             with CUDA-event times (median of 30, L2 flushed before each)
             of the kernel, the plain version and one PyTorch library call;
4. serving — a synthetic 27-subject cache, 4 requests of 64 raw windows
             through ``serving/forward.py`` (Z checked finite, of shape
             (64, 1024, 360), and against the same model on the CPU), then
             the eval CLI over the test pools.  The kernels' launch counts
             are zeroed just before and read just after;
5. the ``kernels`` line, then the ``ok`` line.

Any failure raises and exits non-zero.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from meg_decoding_tpu_torch.cli import evaluate_speech
from meg_decoding_tpu_torch.core.config import compose
from meg_decoding_tpu_torch.data.gwilliams import (
    build_gwilliams_dataset,
    load_gwilliams_cache,
)
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.sampling import random_split
from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import quantile as qk
from meg_decoding_tpu_torch.ops.kernels import window_gather as wg
from meg_decoding_tpu_torch.serving.forward import make_serving_forward

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
N_SUBJECTS, C, F, RATE, REC_SEC, WORDS = 27, 208, 1024, 120, 20.0, 96
BATCH, N_REQUESTS = 64, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, the L2 cache
    flushed (a 256 MB memset) before each so every run reads cold."""
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
    nbytes = B * Cs * L * (4 + out_bytes) + 2 * B * 4
    return {
        "shape": [B, Cs, L], "src": list(src.shape),
        "out_dtype": str(out_dtype or torch.float32),
        "tolerance": "bit-exact", "bit_exact": True, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: wg.window_gather(
            src, rec, on, L, out_dtype=out_dtype), flush),
        "plain_ms": time_ms(lambda: wg.window_gather_plain(
            src, rec, on, L, out_dtype=out_dtype), flush),
        "library_ms": (time_ms(lambda: src[i_r, i_c, i_t], flush)
                       if out_dtype is None else None),
        "bytes": nbytes,
        "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
    }


def phase_kernels(ds, flush) -> dict:
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

    # percentiles of a baseline-corrected X batch, as the collate fits them,
    # with rows of NaN (both signs), ±inf, ±0, constants and duplicates
    X = wg.window_gather(rec_flat, torch.arange(BATCH, device="cuda") % (S * NT),
                         torch.arange(BATCH, device="cuda") * 17, L)
    x2d = (X - X[..., :60].mean(-1, keepdim=True)).reshape(-1, L).contiguous()
    x2d[0] = 3.0
    x2d[1, ::3] = float("nan")
    x2d[2, ::4] = -float("nan")
    x2d[3, ::2], x2d[3, 1::2] = float("inf"), -float("inf")
    x2d[4, ::2], x2d[4, 1::2] = 0.0, -0.0
    x2d[5, : L // 2], x2d[5, L // 2:] = 1.0, -1.0
    x2d[6] = torch.round(x2d[6])
    got = qk.robust_quantiles(x2d)
    want = qk.robust_quantiles_plain(x2d)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError("robust_quantiles: NaN positions differ")
    ulps = ulp_distance(got, want)
    if ulps > 1:
        raise AssertionError(f"robust_quantiles: {ulps} ulp from the plain version")
    # off the main path's shapes: a last CTA with fewer rows than warps,
    # rows shorter than a warp, and rows whose keys need more than the
    # default 48 KB of shared memory
    g = torch.Generator(device="cuda").manual_seed(4)
    for n, t in ((45, 7), (13, 1), (9, 2), (37, 20000)):
        xe = torch.randn(n, t, device="cuda", generator=g)
        e = ulp_distance(qk.robust_quantiles(xe), qk.robust_quantiles_plain(xe))
        if e > 1:
            raise AssertionError(f"robust_quantiles ({n}, {t}): {e} ulp from "
                                 "the plain version")
    fin = torch.isfinite(got) & torch.isfinite(want)
    q_err = float((got[fin] - want[fin]).abs().max())
    q_lib = torch.tensor([0.25, 0.5, 0.75], device="cuda")
    N = x2d.shape[0]
    q_bytes = N * L * 4 + N * 3 * 4
    quant = {"shape": [N, L], "tolerance": "<= 1 ulp", "max_ulp": ulps,
             "max_abs_err": q_err,
             "kernel_ms": time_ms(lambda: qk.robust_quantiles(x2d), flush),
             "plain_ms": time_ms(lambda: qk.robust_quantiles_plain(x2d), flush),
             "library_ms": time_ms(lambda: torch.quantile(x2d, q_lib, dim=1),
                                   flush),
             "bytes": q_bytes, "bound_us": q_bytes / HBM_BYTES_PER_S * 1e6}
    emit({"phase": "kernels", "kernel": "robust_quantiles", **quant})
    return {"gather": cases, "quantiles": quant}


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

    wg.reset_launches()
    qk.reset_launches()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="on-card smoke run of the port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    resolve_device("cuda")  # TF32 off for f32 parity

    phase_build()
    phase_device()

    work = os.path.join(ROOT, "runs_out", f"chip_smoke_{os.getpid()}")
    try:
        t0 = time.perf_counter()
        cache = os.path.join(work, "cache")
        make_synthetic_gwilliams_cache(
            cache, n_subjects=N_SUBJECTS, n_sessions_per=1, C=C, rate=RATE,
            rec_sec=REC_SEC, words_per_task=WORDS, F=F, seed=args.seed)
        cfg = compose(os.path.join(ROOT, "configs"), "config", [
            f"cache_dir={cache}", f"save_root={os.path.join(work, 'out')}",
            f"seed={args.seed}", f"batch_size={BATCH}"])
        ds = build_gwilliams_dataset(cfg, *load_gwilliams_cache(cache),
                                     split_mode=cfg.split_mode,
                                     seed=args.seed, device="cuda")
        tr_idx, _ = random_split(torch.Generator().manual_seed(args.seed),
                                 len(ds), float(cfg.split_ratio))
        cfg.num_subjects = ds.num_subjects
        cfg.num_channels = C
        emit({"phase": "data", "seconds": time.perf_counter() - t0,
              "recordings": list(ds.recordings.shape),
              "y_stream": list(ds.y_stream.shape), "segments": len(ds)})

        flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
        measured = phase_kernels(ds, flush)
        del flush
        launches = phase_serving(cfg, ds, tr_idx, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
    g = measured["gather"][:2]  # one served batch: the X and the f32 Y gather
    q = measured["quantiles"]
    emit({"kernels": [
        {"name": "window_gather", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/window_gather.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/window_gather.py:126",
         "launches": launches["window_gather"],
         "max_abs_err": max(c["max_abs_err"] for c in g),
         "ms": sum(c["kernel_ms"] for c in g),
         "plain_ms": sum(c["plain_ms"] for c in g),
         "bound_ms": sum(c["bound_us"] for c in g) / 1e3, "bound_by": "bytes",
         "library_ms": sum(c["library_ms"] for c in g)},
        {"name": "robust_quantiles", "route": "cuda",
         "source": "meg_decoding_tpu_torch/csrc/robust_quantiles.cu",
         "replaces": "meg_decoding_tpu/ops/pallas/quantile.py:120",
         "launches": launches["robust_quantiles"],
         "max_abs_err": q["max_abs_err"], "ms": q["kernel_ms"],
         "plain_ms": q["plain_ms"], "bound_ms": q["bound_us"] / 1e3,
         "bound_by": "bytes", "library_ms": q["library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
