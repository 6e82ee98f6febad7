"""A closed-loop client of the served forward: it sends one request of raw
windows from host memory, as a decoding client holds them, waits until
the card has finished it (``torch.cuda.synchronize``), and sends the
next.  The program stages each request to the card itself.

Set-up (``setup_s``): the program's kernels found or built, the model's
weights and BN running statistics made on the card from the seed, a pool
of ``request_pool`` distinct requests made on the card from the seed and
copied to (pageable) host memory, and ``warmup_requests`` requests (the
first captures the graph).  The window's peak memory is what the process
holds on the card (``max_memory_reserved``: the graph's pool with it),
counted from after the warm-up.  The window sends requests until
``--seconds`` have passed on the host clock; each request's latency is
its host-clock time from the send to the end of its synchronize.  Every
``sample_every``-th request (from an offset drawn from the seed) keeps
its output.  A traced run then traces ``trace_requests`` more.  Once the
peak memory is read and the program's state freed, the reference serves
the kept requests again.

The mix's keys: ``batch_size``, ``compute_dtype``, ``gelu_impl``,
``request_pool``, ``warmup_requests``, ``sample_every``,
``trace_requests``, ``control``, and ``intra_op_threads`` (the
process's ``torch.set_num_threads``; torch's default where absent).  A
latency-bound client runs one: the program's copy of a request into its
pinned buffer runs on torch's intra-op pool, and on a host whose cores
are shared a descheduled pool thread holds the request for milliseconds
(PERF.md).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchcore import checks
from benchcore.data import (
    make_running,
    make_weights,
    np_rng,
    sensor_locations,
    torch_gen,
)
from benchcore.trace import capture
from reference.model import buffer_spec, fourier_basis, param_spec
from reference.train import precision, serve


def model_tensors(cfg: dict, seed: int, device) -> tuple:
    m = cfg["model"]
    spec = param_spec(m["C"], cfg["data"]["subjects"], m["D1"], m["D2"],
                      m["F"], m["K"], m["num_blocks"])
    weights = make_weights(spec, m["init_temperature"], seed, device)
    running = make_running(buffer_spec(m["D2"], m["num_blocks"]), seed, device)
    return weights, running


def requests(cfg: dict, mix: dict, seed: int, device) -> tuple:
    """(X (pool, B, C, T) f32, subjects (pool, B) int32), made on
    ``device`` from the seed and returned in host memory."""
    m, d = cfg["model"], cfg["data"]
    T = int(d["seq_len_sec"] * d["rate"])
    shape = (mix["request_pool"], mix["batch_size"], m["C"], T)
    X = torch.randn(shape, generator=torch_gen(device, seed, "requests"),
                    device=device)
    subs = np_rng(seed, "request_subjects").integers(
        0, d["subjects"], shape[:2]).astype(np.int32)
    return X.cpu(), torch.from_numpy(subs)


def reference_outputs(cfg: dict, kept: list, X, subs, seed: int, device,
                      arithmetic: str = "float32") -> list:
    m = cfg["model"]
    weights, running = model_tensors(cfg, seed, device)
    loc = torch.as_tensor(sensor_locations(cfg), device=device)
    cos, sin = fourier_basis(loc.cpu().numpy(), m["K"], device)
    out = []
    with precision(arithmetic, device) as q:
        for j in kept:
            out.append(serve(weights, running, X[j].to(device),
                             subs[j].to(device), m, loc, cos, sin,
                             cfg["collate"], q))
    return out


def run(ctx) -> dict:
    from benchcore import port

    ctx.mark("imports")
    cfg, mix = ctx.config, ctx.mix
    if mix.get("intra_op_threads"):
        torch.set_num_threads(int(mix["intra_op_threads"]))
    dev = port.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        ctx.mark("device")
        port.build_kernels()
        ctx.mark("kernels")
    weights, running = model_tensors(cfg, ctx.seed, dev)
    server = port.Server(cfg, mix, weights, running, sensor_locations(cfg),
                         dev)
    del weights, running
    X, subs = requests(cfg, mix, ctx.seed, dev)
    ctx.mark("data")
    pool = len(X)
    rng = np_rng(ctx.seed, "order")
    order = rng.permutation(pool)
    every = mix["sample_every"]
    offset = int(rng.integers(0, every))
    if cuda:
        torch.cuda.empty_cache()
    for i in range(mix["warmup_requests"]):
        server(X[i % pool], subs[i % pool])
        ctx.sync()
    if cuda:
        # the peak is the window's: what the process holds on the card
        # (the graph's pool included) from here on
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.mark("warmup")
    before = port.counters()
    lat, kept, outputs = [], [], []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        i = len(lat)
        j = int(order[i % pool])
        t = time.perf_counter()
        Z = server(X[j], subs[j])
        ctx.sync()
        now = time.perf_counter()
        lat.append(now - t)
        if i % every == offset:
            # to host memory, after the request's time is taken, so that
            # the kept outputs hold no memory on the card
            kept.append(j)
            outputs.append(Z.cpu())
        if now - t_start >= ctx.seconds:
            break
    replays = port.counters()["replays.forward"] - before["replays.forward"]
    ms = np.asarray(lat) * 1e3
    record = {"e2e": {"request_ms_p50": float(np.percentile(ms, 50)),
                      "request_ms_p95": float(np.percentile(ms, 95)),
                      "setup_s": setup_s},
              "attempted": len(lat), "request_ms": ms}
    if ctx.trace:
        traced = [int(order[(len(lat) + k) % pool])
                  for k in range(mix["trace_requests"])]

        def run_traced():
            for j in traced:
                server(X[j], subs[j])
                ctx.sync()

        record["trace"] = capture(run_traced, len(traced), ctx.sync)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                   if cuda else 0)
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = reference_outputs(cfg, kept, X, subs, ctx.seed, dev)
    gaps = [checks.serve_gap(z, r) for z, r in zip(outputs, refs)]
    record["failed"] = sum(not bool(torch.isfinite(z).all()) for z in outputs)
    record["numbers"] = {"output": max(gaps) if gaps else float("inf"),
                         "eager_requests": float(len(lat) - replays
                                                 if cuda else 0)}
    return record
