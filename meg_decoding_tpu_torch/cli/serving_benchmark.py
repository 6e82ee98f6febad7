"""Serving latency: the serving forward, eager and graphed, and a serving
artifact.  Counterpart of ``examples/serving_benchmark.py``.

At each batch size it times requests of raw windows at the full Gwilliams
width (C = 208, T = 360, 27 subjects; ``configs/config.yaml``'s encoder:
D1 = 270, D2 = 320, F = 1024, K = 32, seq2seq with ``--seq2seq``, else
mean-pooled) through the serving forward (``serving/export.py:
make_serving_forward``, the collate chain and the eval-mode encoder,
random weights from ``--seed``), as its eager body (``eager``) and as the
replay of its captured CUDA graph (``graph``, the route the eval CLIs
take), and, with ``--artifact DIR``, through the artifact loaded from DIR
(``artifact``: ``load_artifact``, one graph per batch size; its input
shape and subject count from its ``meta.json``).  A request ends when the
card has finished it (``torch.cuda.synchronize``); the first request of a
source and size is timed apart (``first_ms``: a graph's capture).  Prints
one JSON line per batch size and source: ``p50_ms``, ``p90_ms``,
``best_ms``, ``samples_per_sec_at_p50`` and, on the card, from
``torch.profiler`` over as many requests again, the device operations and
busy ms a request and the idle share of the traced window, beside the
card's name and power limit (``nvidia-smi``).  On the CPU those three are
null: a CPU run measures no device.

Run: ``python -m meg_decoding_tpu_torch.cli.serving_benchmark
[--device cuda] [--batches 1,8,64] [--iters 50] [--seq2seq]
[--artifact DIR]``
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device

__all__ = ["latency_row", "request_profile", "full_width_encoder", "main"]

C, T, F, NUM_SUBJECTS = 208, 360, 1024, 27
BASELINE_LEN_SAMP, CLAMP_LIM = 60, 20.0  # config.yaml: 0.5 s at 120 Hz, ±20


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def latency_row(call, X: torch.Tensor, subs: torch.Tensor, iters: int,
                device: torch.device) -> dict:
    """Times ``call(X, subs)`` ``iters`` times after one first call, each
    ended by a synchronize: the first call's ms, then p50, p90 and best in
    ms, samples/s at p50."""
    _sync(device)
    t0 = time.perf_counter()
    call(X, subs)
    _sync(device)
    first = (time.perf_counter() - t0) * 1e3
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call(X, subs)
        _sync(device)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    p50 = float(np.percentile(lat, 50))
    return {"batch": int(X.shape[0]), "first_ms": first, "p50_ms": p50,
            "p90_ms": float(np.percentile(lat, 90)), "best_ms": float(lat.min()),
            "samples_per_sec_at_p50": X.shape[0] / p50 * 1e3}


def request_profile(call, X: torch.Tensor, subs: torch.Tensor, n: int,
                    device: torch.device) -> dict:
    """``torch.profiler`` over ``n`` requests, each ended by a synchronize:
    device operations (kernels, copies, memsets) and busy ms a request,
    and the share of the traced window in which the card ran nothing.
    Null on the CPU."""
    keys = ("device_ops_per_request", "busy_ms_per_request", "idle_share")
    if device.type != "cuda":
        return dict.fromkeys(keys)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from meg_decoding_tpu_torch.cli.profile_train_step import busy_us

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call(X, subs)
            _sync(device)
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return dict(zip(keys, (len(kernels) / n, busy / 1e3 / n,
                           1.0 - busy / window_us)))


def full_width_encoder(device: torch.device, seq2seq: bool, seed: int = 0):
    """The speech encoder of ``configs/config.yaml`` with random weights
    (``data/layout.py``'s synthetic cap for the 208 sensors)."""
    from meg_decoding_tpu_torch.data.layout import (
        normalize_locations,
        synthetic_cap_locations,
    )
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    loc = normalize_locations(synthetic_cap_locations(C))
    return BrainEncoder(loc, NUM_SUBJECTS, D1=270, D2=320, F=F, K=32,
                        seq2seq=seq2seq, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq2seq", action="store_true",
                    help="seq2seq head (speech); default mean-pooled")
    ap.add_argument("--artifact", default=None,
                    help="also time the serving artifact in this directory")
    args = ap.parse_args(argv)

    from meg_decoding_tpu_torch.serving.export import (
        load_artifact,
        make_serving_forward,
    )
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from meg_decoding_tpu_torch.cli.profile_train_step import nvidia_smi

        card = nvidia_smi()
    else:
        card = "cpu"
    model = full_width_encoder(dev, args.seq2seq, args.seed)
    forward = make_serving_forward(CollateConfig(
        baseline_len_samp=BASELINE_LEN_SAMP, clamp_lim=CLAMP_LIM))
    # source → (call, channels, seq_len, subjects)
    sources = {
        "eager": (lambda X, s: forward.body(model, X, s), C, T, NUM_SUBJECTS),
        "graph": (lambda X, s: forward(model, X, s), C, T, NUM_SUBJECTS)}
    if args.artifact:
        served = load_artifact(args.artifact, device=dev)
        sources["artifact"] = (served, *served.meta["input"]["X"][1:],
                               int(served.meta.get("num_subjects", 1)))
    rows = []
    for B in [int(b) for b in args.batches.split(",")]:
        for name, (call, channels, seq_len, n_subjects) in sources.items():
            rng = np.random.RandomState([args.seed, B])
            X = torch.from_numpy(rng.randn(B, channels, seq_len)
                                 .astype(np.float32)).to(dev)
            subs = torch.from_numpy(rng.randint(0, n_subjects, B)
                                    .astype(np.int32)).to(dev)
            row = {"source": name, **latency_row(call, X, subs, args.iters, dev),
                   **request_profile(call, X, subs, args.iters, dev),
                   "device": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
