"""A closed-loop client of the speech-stimulus encoder: it sends one
stimulus file a request from host memory, as a cache build holds its
audio, and waits for the embedding in host memory before it sends the
next.  The program uploads the file, embeds it in fixed-size chunks (each
a replay of its chunk graph) and the client copies the (H, T′) result
back.

Set-up (``setup_s``): the program's kernels found or built, the model's
weights made on the card from the seed and copied into the program's
model, the pool of stimulus files made on the card from the seed and
copied to (pageable) host memory, and ``warmup_requests`` requests (the
first captures the chunk graph; a program that replays no chunk graph
there cannot run the cell, and the run stops with an error).  The
window's peak memory is what the process holds on the card
(``max_memory_reserved``: the graph's pool with it), counted from after
the warm-up.  The window sends the pool's files in an order drawn from
the seed, pass after pass, and ends at the end of the first whole pass
after ``--seconds`` (``min_passes`` at least), so that every window holds
each file equally often; each request's latency is its host-clock time
from the send to the embedding in host memory.  The first request of a
file of each of ``kept_chunks`` chunk counts (the file drawn from the
seed among those) keeps its embedding.  A traced run then traces
``trace_requests`` more; its unit is a chunk.  Once the peak memory is
read and the program's state freed, the reference (``reference/
wav2vec2.py``) embeds the kept files again.

The pool: ``files`` files whose lengths are evenly spaced from
``min_sec`` to ``max_sec`` (a fixed ladder, the same for every seed, so
every window holds the same chunk counts), each ``amplitude``·N(0, 1) at
the configuration's sample rate.  The mix's keys: those, and
``warmup_requests``, ``min_passes``, ``kept_chunks``, ``trace_requests``,
``control`` (the precision of the comparison's control).

The compared numbers: ``output``, the worst kept file's max |E − E_ref|
over max |E_ref| (inf where the lengths differ); ``frames``, the largest
|T′ − T′_ref|; ``eager_chunks``, the window's chunks that did not replay
a graph.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchcore import checks
from benchcore.counts import PEAKS
from benchcore.counts_w2v import w2v_flops
from benchcore.data import np_rng, torch_gen
from benchcore.trace import capture
from reference import wav2vec2 as ref
from reference.train import precision


def model_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of ``reference.wav2vec2.param_spec``, drawn on the
    device from the seed as the program's ``init_random`` draws them."""
    gen = torch_gen(device, seed, "weights")
    out = {}
    for name, shape, init in ref.param_spec(cfg["model"]):
        kind = init[0]
        if kind == "tap_norm":
            v = out[init[1]]
            out[name] = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
            continue
        t = torch.empty(shape, device=device)
        if kind == "he":
            t.normal_(0.0, math.sqrt(2.0 / (shape[1] * shape[2])),
                      generator=gen)
        elif kind == "normal":
            t.normal_(0.0, init[1], generator=gen)
        elif kind == "uniform":
            t.uniform_(init[1], init[2], generator=gen)
        else:
            t.fill_(1.0 if kind == "ones" else 0.0)
        out[name] = t
    return out


def audio_pool(cfg: dict, mix: dict, seed: int, device) -> list:
    """The pool's waveforms, 1-D f32 in (pageable) host memory, made on
    ``device`` from the seed."""
    sr = cfg["audio"]["sample_rate"]
    lengths = [int(round(s * sr)) for s in
               np.linspace(mix["min_sec"], mix["max_sec"], mix["files"])]
    flat = mix["amplitude"] * torch.randn(
        sum(lengths), generator=torch_gen(device, seed, "audio"),
        device=device)
    return list(torch.split(flat.cpu(), lengths))


def chunks_of(cfg: dict, n_samples: int) -> int:
    """The chunks a file of ``n_samples`` is embedded in (the reference's
    plan); 0 for a file of one chunk or less, which runs at its own
    length and replays no graph."""
    a = cfg["audio"]
    n = len(ref.chunk_plan(cfg["model"], n_samples, a["chunk_sec"],
                           a["overlap_sec"], a["sample_rate"]))
    return n if n > 1 else 0


def request_flops(cfg: dict, n_samples: int) -> float:
    """Model FLOPs of one request: a full-size forward a chunk."""
    a = cfg["audio"]
    n = chunks_of(cfg, n_samples)
    if n == 0:
        return w2v_flops(cfg["model"], n_samples)
    stride = math.prod(cfg["model"]["conv_stride"])
    chunk = int(a["chunk_sec"] * a["sample_rate"]) // stride * stride
    return n * w2v_flops(cfg["model"], chunk)


def kept_files(cfg: dict, mix: dict, files: list, seed: int) -> list:
    """One file of each of ``kept_chunks`` chunk counts, drawn from the
    seed."""
    rng = np_rng(seed, "kept")
    counts = [chunks_of(cfg, len(f)) for f in files]
    out = []
    for c in mix["kept_chunks"]:
        among = [j for j, n in enumerate(counts) if n == c]
        if not among:
            raise ValueError(f"no file of the pool has {c} chunks: {counts}")
        out.append(int(rng.choice(among)))
    return out


def reference_outputs(cfg: dict, kept: list, files: list, seed: int, device,
                      arithmetic: str = "float32") -> list:
    w = model_weights(cfg, seed, device)
    a = cfg["audio"]
    with precision(arithmetic, device):
        return [ref.embed(w, cfg["model"], files[j].to(device),
                          a["chunk_sec"], a["overlap_sec"],
                          a["sample_rate"]) for j in kept]


def compare(outputs: list, refs: list) -> dict:
    """``output`` and ``frames`` of the kept files."""
    gaps, frames = [], []
    for E, R in zip(outputs, refs):
        frames.append(abs(E.shape[-1] - R.shape[-1]))
        gaps.append(checks.serve_gap(E, R) if E.shape == R.shape
                    else math.inf)
    return {"output": max(gaps) if gaps else math.inf,
            "frames": float(max(frames)) if frames else math.inf}


def run(ctx) -> dict:
    from benchcore import port_features as port

    ctx.mark("imports")
    cfg, mix = ctx.config, ctx.mix
    dev = port.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        ctx.mark("device")
        port.build_kernels()
        ctx.mark("kernels")
    weights = model_weights(cfg, ctx.seed, dev)
    embedder = port.Embedder(cfg, weights, dev)
    del weights
    files = audio_pool(cfg, mix, ctx.seed, dev)
    chunks = [chunks_of(cfg, len(f)) for f in files]
    flops = [request_flops(cfg, len(f)) for f in files]
    kept = kept_files(cfg, mix, files, ctx.seed)
    order = [int(j) for j in np_rng(ctx.seed, "order").permutation(len(files))]
    ctx.mark("data")
    if cuda:
        torch.cuda.empty_cache()
    before = port.counters()["replays.forward"]
    for i in range(mix["warmup_requests"]):
        embedder(files[order[i % len(order)]]).cpu()
    replayed = port.counters()["replays.forward"] - before
    if cuda and replayed == 0:
        raise RuntimeError("the program replayed no chunk graph in the "
                           "warm-up: it cannot run this cell")
    if cuda:
        # the peak is the window's: what the process holds on the card
        # (the weights, the graph's pool) from here on
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.mark("warmup")
    before = port.counters()["replays.forward"]
    lat, sent, outputs, failed, passes = [], [], {}, 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        for j in order:
            t = time.perf_counter()
            E = embedder(files[j]).cpu()
            lat.append(time.perf_counter() - t)
            sent.append(j)
            failed += not bool(torch.isfinite(E).all())
            if j in kept and j not in outputs:
                outputs[j] = E
        passes += 1
        if (passes >= mix["min_passes"]
                and time.perf_counter() - t_start >= ctx.seconds):
            break
    replays = port.counters()["replays.forward"] - before
    ms = np.asarray(lat) * 1e3
    record = {"e2e": {"request_ms_p50": float(np.percentile(ms, 50)),
                      "request_ms_p95": float(np.percentile(ms, 95)),
                      "setup_s": setup_s},
              "attempted": len(lat), "failed": failed, "request_ms": ms,
              "passes": passes, "request_s": float(np.sum(lat)),
              "window_flops": float(sum(flops[j] for j in sent)),
              "peak_flops": PEAKS["float32"]}
    if ctx.trace:
        traced = [order[k % len(order)] for k in range(mix["trace_requests"])]

        def run_traced():
            for j in traced:
                embedder(files[j]).cpu()

        record["trace"] = capture(run_traced,
                                  max(sum(chunks[j] for j in traced), 1),
                                  ctx.sync)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                   if cuda else 0)
    del embedder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = reference_outputs(cfg, kept, files, ctx.seed, dev)
    window_chunks = sum(chunks[j] for j in sent)
    record["numbers"] = {**compare([outputs[j] for j in kept], refs),
                         "eager_chunks": float(window_chunks - replays
                                               if cuda else 0)}
    return record
